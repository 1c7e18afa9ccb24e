"""decode_ms_per_block.verify: the harness span `decode` summed over the window, in ms
per block (host clock)."""


def read(run):
    if run.kind != "verify" or not run.spans.get("decode"):
        return None
    return sum(run.spans["decode"]) / run.counts["blocks"] * 1e3
