"""Tensor ops: plain PyTorch functions and the hand-written CUDA kernels
(the level, forward and backward; the bank, forward and backward; the
aligned neighbour tensor)."""


def launch_counts() -> dict:
    """The launch counts of the models' kernels' wrappers in this process:
    the level K1, its backward K2 (kernel 1, and kernel 2 as ``K2r``), the
    bank K4 and its backward K5 (kernel 1, and kernel 2 as ``K5r``)."""
    from graphflow_tpu_torch.ops.risi_bank import (risi18_bank,
                                                   risi18_bank_backward)
    from graphflow_tpu_torch.ops.risi_level import (risi18_level,
                                                    risi18_level_backward)

    return {"K1": risi18_level.launches,
            "K2": risi18_level_backward.launches,
            "K2r": risi18_level_backward.reduce_launches,
            "K4": risi18_bank.launches,
            "K5": risi18_bank_backward.launches,
            "K5r": risi18_bank_backward.reduce_launches}
