"""verify_call_ms_per_block.verify: the harness span `verify_call` summed over the window, in ms
per block (host clock)."""


def read(run):
    if run.kind != "verify" or not run.spans.get("verify_call"):
        return None
    return sum(run.spans["verify_call"]) / run.counts["blocks"] * 1e3
