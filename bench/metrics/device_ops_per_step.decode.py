"""Device operations (kernels, copies, fills) in the trace over the decode
steps of the window."""


def read(run):
    steps = run.facts["steps"]
    return run.trace.count() / steps if steps and run.trace.count() else None
