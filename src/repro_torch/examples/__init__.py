"""The port's counterparts of the reference's `examples/quickstart.py`
and `examples/poi_serving.py`, single-device as theirs are:

    python -m repro_torch.examples.quickstart            # on the card
    python -m repro_torch.examples.poi_serving --device cpu
"""
