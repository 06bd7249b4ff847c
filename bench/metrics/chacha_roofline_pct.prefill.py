"""The ChaCha20 kernel's share of its roofline on the expert exchange: four
launches a layer a prefill (two legs, each encrypted and decrypted), each
reading and writing a leg's wire once, over the kernel's device time, in %."""

from bench import yardstick
from bench.common import kernel_names


def read(run):
    spent = run.trace.kernel_s(kernel_names("chacha20"))
    if spent <= 0:
        return None
    f = run.facts
    launches = f["prefills"] * 4 * f["model"]["n_layers"]
    return 100.0 * launches * yardstick.crypt_s(f["leg_bytes"]) / spent
