"""Block decodes of tri.cu's main loop, replayed in numpy with the kernel's
own arithmetic, for the tests that check its schedules and stores."""

import numpy as np

# the shapes the schedules are replayed at: ragged, one tile, the paths' M
# (north-star 3,000, MGGP 3,010) and B (7,000)
M_REPLAY = [1, 127, 128, 257, 3000, 3010]
B_REPLAY = [1, 129, 7000]


def dlu_block(bid, nrt):
    """tri_mma_kernel<kDlu>'s block decode: (l, kt, mt), kt >= mt."""
    pairs = nrt * (nrt + 1) // 2
    l, q = divmod(bid, pairs)
    kt = int((np.sqrt(np.float32(8 * q + 1), dtype=np.float32) - np.float32(1))
             * np.float32(0.5))
    while kt * (kt + 1) // 2 > q:
        kt -= 1
    while (kt + 1) * (kt + 2) // 2 <= q:
        kt += 1
    return l, kt, q - kt * (kt + 1) // 2


def dc_block(bid, nrt, nct):
    """The dc epilogue's block decode (tri_mma_kernel<kDc>): (l, mt, bt),
    factor slowest, then the column tile, then the row tile, the longest k
    loop (mt = 0) first."""
    l, r = divmod(bid, nct * nrt)
    return l, r % nrt, r // nrt


def da_block(bid, nrt, nct):
    """Kernel 7's block decode (tri_mma_kernel<kDa>): (l, kt, bt), factor
    slowest, then the column (b) tile, then the row (k) tile, the longest m
    loop (kt = nrt - 1) first."""
    l, r = divmod(bid, nct * nrt)
    return l, nrt - 1 - r % nrt, r // nrt
