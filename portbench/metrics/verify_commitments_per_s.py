"""verify_commitments_per_s: the commitments of every block that got its
verdict in the window, over all the window's time (host clock)."""


def read(run):
    return run.counts["commitments"] / run.window_s if run.kind == "verify" else None
