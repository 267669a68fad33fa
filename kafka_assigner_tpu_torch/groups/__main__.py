"""``python -m kafka_assigner_tpu_torch.groups``: the port's ``ka-groups``."""
from ..cli import groups_main

if __name__ == "__main__":
    groups_main()
