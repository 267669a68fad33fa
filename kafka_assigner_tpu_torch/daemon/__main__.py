"""``python -m kafka_assigner_tpu_torch.daemon``: the port's ``ka-daemon``."""
from ..cli import daemon_main

if __name__ == "__main__":
    daemon_main()
