"""Device busy time in the trace over the rounds the window's jobs executed
(the sum of their `n_iter`), in ms a round."""


def read(run):
    rounds = sum(r for _, r in run.facts["rounds"])
    return 1e3 * run.trace.busy_s / rounds if rounds and run.trace.busy_s else None
