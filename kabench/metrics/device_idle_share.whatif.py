"""device_idle_share.whatif: the share of the traced window in which no
kernel, copy or memset ran on the card (``torch.profiler``'s device
intervals merged), in percent."""
SOURCE = "device_trace"
MOVES = "scenarios_per_s"


def read(run):
    if run.kind != "whatif" or run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
