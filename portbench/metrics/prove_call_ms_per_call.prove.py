"""prove_call_ms_per_call.prove: the harness span `prove_call` summed over the window, in ms
per call (host clock)."""


def read(run):
    if run.kind != "prove" or not run.spans.get("prove_call"):
        return None
    return sum(run.spans["prove_call"]) / run.counts["calls"] * 1e3
