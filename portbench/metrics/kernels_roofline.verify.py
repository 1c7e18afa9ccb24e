"""kernels_roofline.verify: the least time the window's work needs on the
card (harness/work_model.py) over the card's busy time in the traced
window; nothing where the card did no work."""


def read(run):
    if run.kind != "verify" or not run.trace or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * run.least_s / run.trace["busy_s"]
