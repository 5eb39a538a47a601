"""The port's counterparts of the reference's examples, single-device as
theirs are (`decentralized_lm` runs its learners stacked on one device,
where the reference needs a mesh of 8 host devices):

    python -m repro_torch.examples.quickstart            # on the card
    python -m repro_torch.examples.poi_serving --device cpu
    python -m repro_torch.examples.train_lm --steps 50 --d-model 256
    python -m repro_torch.examples.decentralized_lm --steps 40
"""
