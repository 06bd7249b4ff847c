"""Launch tools of the port (`hillclimb`: the offline knob search, cells S
and K; `dryrun`: every (arch x shape) cell run abstractly on one card)."""
