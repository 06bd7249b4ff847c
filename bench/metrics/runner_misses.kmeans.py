"""Runner-cache misses over the window (`RunnerCache.misses`): 0 when set-up
captured every runner the window's jobs use."""


def read(run):
    return run.facts["runner_misses"]
