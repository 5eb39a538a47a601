"""Small sizes at which the tests run the benchmark on the CPU, through
the program's plain-kernel path."""

CONFIG = {"dataset": {"n_users": 300, "n_items": 200, "n_ratings": 2500, "n_cities": 8}}
TRAFFIC = {"refresh": {"microbatch": 64, "orders": 4, "trace_passes": 2},
           "train": {"batch_size": 256, "epochs": 4, "trace_jobs": 1}}
KIND = {"alipay.refresh": "refresh", "foursquare.refresh": "refresh",
        "alipay.train": "train", "foursquare.train": "train"}
