"""commit_ms_per_call.prove: the harness span `commit` summed over the window, in ms
per call (host clock)."""


def read(run):
    if run.kind != "prove" or not run.spans.get("commit"):
        return None
    return sum(run.spans["commit"]) / run.counts["calls"] * 1e3
