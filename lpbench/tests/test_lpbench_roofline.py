import numpy as np
import scipy.sparse as sp

from lpbench import roofline


def test_pass_bytes_hand_count():
    # A 2 x 3 with 4 entries: A's CSR 3 row pointers, A''s 4, 4 + 4
    # column indices (int32); 4 + 4 values (f32); x, A x = 3 + 2,
    # y, A'y = 2 + 3 (f32)
    a = sp.csr_matrix(np.array([[1.0, 0, 2], [0, 3, 4]]))
    m, n = a.shape
    assert roofline.pass_bytes(m, n, a.nnz) == 4 * (3 + 4 + 4 + 4) + 4 * (
        4 + 4 + 5 + 5)


def test_peak_of_the_card_only():
    assert roofline.peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.peak_bytes_per_s("cpu") is None
