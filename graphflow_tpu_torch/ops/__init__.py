"""Tensor ops: plain PyTorch functions and the hand-written CUDA kernels
(the level, forward and backward; the bank, forward and backward; the
aligned neighbour tensor).

The package re-exports every op that ``graphflow_tpu.ops`` exports, under
the same names.  The kernel wrappers' modules (``risi_level``,
``risi_bank``, ``risi_aligned``, ``risi_bank_ablate``) are not imported
here; each builds its kernel at its first CUDA launch."""

from graphflow_tpu_torch.ops.activations import (
    dropout, identity, leaky_relu, masking, norm3d, relu, sigmoid, softmax,
    tanh)
from graphflow_tpu_torch.ops.contractions import (
    dropout_case_mask, risi_contraction_4, risi_contraction_10,
    risi_contraction_18, risi_contraction_18_batched,
    risi_contraction_18_dropout, risi_contraction_18_spec,
    risi_contraction_50)
from graphflow_tpu_torch.ops.conv import (avg_pool2d, conv1d, conv2d,
                                          max_pool2d)
from graphflow_tpu_torch.ops.linalg import (
    add, custom_matmul_tensor, inner_product, linear_gram, mat_broadcast_mat,
    mat_tensor_mul, mat_vec_mul, matmul, multiply, outer_product,
    scalar_matmul, subtract, tensor4d_tensor3d_mul, tensor_mat_mul,
    tensor_mul, transpose, vector_add_matrix, vector_add_tensor,
    vector_broadcast_mat)
from graphflow_tpu_torch.ops.losses import (l1_regularization,
                                            l2_regularization, log_loss,
                                            squared_loss)
from graphflow_tpu_torch.ops.reductions import (
    average_vectors, concat, kmax, matrix_concat, reshape2d, reshape3d,
    reshape4d, risi_layer_1d, risi_layer_2d, risi_layer_3d, shrink_matrix,
    shrink_tensor, shuffle_matrix, sort_vector, stack_tensor3d, sum_components,
    sum_matrices, sum_rows, sum_tensor3d, sum_vectors, tensor3d_concat,
    tensor4d_concat, vertex_representation)


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
