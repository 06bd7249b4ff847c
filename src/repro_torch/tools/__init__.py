"""Introspection helpers of the port (`opcount`: what one run of a function
did, counted; `roofline`: parameter and model-FLOP counts and the card's
roofline terms; `report_md`: the dry-run's tables)."""
