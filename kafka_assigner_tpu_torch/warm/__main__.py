"""``python -m kafka_assigner_tpu_torch.warm``: the port's ``ka-warm``."""
from ..cli import warm_main

if __name__ == "__main__":
    warm_main()
