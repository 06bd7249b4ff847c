"""Introspection helpers of the port (`opcount`: what one run of a function
did, counted)."""
