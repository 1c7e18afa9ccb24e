"""prove_commitments_per_s: the commitments whose outputs (commitment,
proof and wire bytes) were made in the window, over all its time (host clock)."""


def read(run):
    return run.counts["commitments"] / run.window_s if run.kind == "prove" else None
