"""The ChaCha20 kernel's share of its roofline on the expert exchange: two
launches a leg (encrypt, decrypt), each reading and writing the leg's wire
once, over the kernel's device time, in %."""

from bench import yardstick
from bench.common import kernel_names

KERNEL = "chacha20"


def read(run):
    spent = run.trace.kernel_s(kernel_names(KERNEL))
    if spent <= 0:
        return None
    f = run.facts
    launches = f["prefills"] * 2 * f["legs"]
    return 100.0 * launches * yardstick.crypt_s(f["leg_bytes"]) / spent
