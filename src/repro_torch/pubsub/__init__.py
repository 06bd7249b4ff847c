"""SCBR — secure content-based routing (the paper's pub/sub substrate [12]).

Counterpart of `repro/pubsub`: host-side Python over the port's host
ChaCha20 and keys.

Subscriptions and publication headers are encrypted on the wire and matched
only inside the router's "enclave"; payloads are encrypted under a different
key and are opaque to the router. The MapReduce session-establishment and
provisioning protocols (paper Figs. 3-4) live in `protocol.py`.
"""

from repro_torch.pubsub.messages import Message, Subscription
from repro_torch.pubsub.router import ScbrRouter

__all__ = ["Message", "Subscription", "ScbrRouter"]
