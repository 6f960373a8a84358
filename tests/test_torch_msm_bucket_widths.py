"""``msm_bucket``'s plain version (kernel C3's staged algorithm) on the CPU at
the bucket widths w = 5..8, against the JAX package's ``msm_bucket`` and the
host oracle: the wide half of ``test_torch_msm_bucket.py``'s
``test_msm_bucket_equals_jax_and_host`` (w = 2..4 there).  Nearly all of its
time is the JAX algorithm's, run as ``jax_msm_bucket`` runs it; a file of
its own lets ``--dist loadfile`` give it a worker of its own."""

import pytest

from dvt_circuits_tpu_torch.curve import g1

from .test_torch_msm_bucket import (  # noqa: F401  (fixtures)
    _oracle,
    _points,
    _scalars,
    jax_msm_bucket,
    one_torch_thread,
)


@pytest.mark.parametrize("window_bits", range(5, 9))
def test_msm_bucket_equals_jax_and_host(jax_msm_bucket, window_bits):  # noqa: F811
    points, scalars = _points(2), _scalars(20 + window_bits, 2)
    want = _oracle(points, scalars)
    assert g1.msm_bucket(points, scalars, window_bits, device="cpu") == want
    assert jax_msm_bucket(points, scalars, window_bits) == want
