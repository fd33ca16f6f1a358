"""Per-layer metric ``rn_epilogue_roofline.index``: see ``read``."""

from portbench import flops
from portbench.metrics import _epilogue

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "index_card_images_per_s"


def read(ctx: dict):
    """The least time the modified ResNet's conv epilogues of the traced
    sub-window need, the program's ``rn_epilogue_bytes`` over the
    sub-window (every operand read and the output written once, as the
    program launched them) at the card's bandwidth, over the device
    seconds of the epilogue ops (``_epilogue.is_epilogue``). Nothing
    where the counter is absent or zero. The bytes are counted as the
    host launches and the seconds as the card runs; over a sub-window
    of some 16 batches the lag between the two is a small part of
    either."""
    need = _epilogue.counted(ctx, _epilogue.BYTES)
    if need <= 0:
        return None
    spent = _epilogue.epilogue_s(ctx["trace"])
    if spent <= 0:
        return None
    return 100.0 * need / flops.PEAK_HBM_BYTES_PER_S / spent
