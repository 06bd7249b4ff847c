"""Launch tools of the port (`hillclimb`: the offline knob search, cells S
and K)."""
