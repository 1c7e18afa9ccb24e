"""device_idle_pct.verify: the share of the traced window in which no kernel
or copy ran on the card (torch.profiler's device trace)."""


def read(run):
    if run.kind != "verify" or not run.trace or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
