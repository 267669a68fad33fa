"""``python -m kafka_assigner_tpu_torch.exec``: the port's ``ka-execute``."""
from ..cli import execute_main

if __name__ == "__main__":
    execute_main()
