"""The ChaCha20 kernel's share of its roofline on the k-means wire: two
launches an executed round (encrypt, decrypt), each reading and writing the
wire once, over the kernel's device time in the trace, in %."""

from bench import yardstick
from bench.common import kernel_names

KERNEL = "chacha20"


def read(run):
    spent = run.trace.kernel_s(kernel_names(KERNEL))
    if spent <= 0:
        return None
    f = run.facts
    wire = f["shards"] * f["shards"] * yardstick.kmeans_wire_words(f["k"], f["d"], f["shards"]) * 4
    rounds = sum(r for _, r in f["rounds"])
    return 100.0 * rounds * 2 * yardstick.crypt_s(wire) / spent
