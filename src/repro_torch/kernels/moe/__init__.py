"""The MoE prefill's dispatch and combine through the routing's slot map:
the Hopper kernels (`kernel.py`), their plain versions (`ref.py`). Their
dispatch by device is `models.moe._moe_shuffle_body`'s no-gradient path."""
