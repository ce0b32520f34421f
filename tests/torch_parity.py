"""Parity helpers shared by the port's tests (``tests/test_torch_*.py``):
not a test module, so pytest does not collect it."""

import numpy as np


def assert_equal_by_tie_group(want_ids, got_ids, want_keys, got_keys,
                              rtol=1e-5):
    """Per row: the keys at each place agree within ``rtol`` of the row's
    largest |key|, and the ids are equal at every place whose key is tied
    (within that) with no other key of the row and not with its last."""
    want_keys, got_keys = np.asarray(want_keys), np.asarray(got_keys)
    for b in range(len(want_ids)):
        tol = rtol * max(float(np.abs(want_keys[b]).max()), 1.0)
        np.testing.assert_allclose(got_keys[b], want_keys[b], rtol=0,
                                   atol=tol, err_msg=f"row {b}")
        k = want_keys[b]
        near = np.abs(k[:, None] - k[None, :]) <= tol
        tied = (near.sum(1) > 1) | (np.abs(k - k[-1]) <= tol)
        np.testing.assert_array_equal(
            np.asarray(got_ids[b])[~tied], np.asarray(want_ids[b])[~tied],
            err_msg=f"row {b}")
