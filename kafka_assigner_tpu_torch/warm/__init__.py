"""``ka-warm`` for the port: seed the library store for a cluster or a
bucket set (``cli.py:run_warm``). Surface: ``python -m
kafka_assigner_tpu_torch.warm``."""
