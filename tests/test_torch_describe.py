"""Port binning vs the reference's `bin_descriptors` on the CPU (its f32
`_bin_chunk_fast` body).  Raw values within rtol 2e-5 (one [G², D²]
contraction summed in another order); uint8 output within 1 step, with a
nonzero step on < 1e-3 of the entries."""

import jax.numpy as jnp
import numpy as np
import torch

from siftgpu_tpu.core.config import SiftConfig as JConfig
from siftgpu_tpu.frontend import describe as jdescribe
from siftgpu_tpu_torch.core.config import SiftConfig
from siftgpu_tpu_torch.frontend import describe


def _inputs(seed, B=2, C=300):
    rng = np.random.default_rng(seed)
    G2 = SiftConfig().descriptor_grid ** 2
    sgx = rng.standard_normal((B, C, G2)).astype(np.float32)
    sgy = rng.standard_normal((B, C, G2)).astype(np.float32)
    th = rng.uniform(0, 2 * np.pi, (B, C)).astype(np.float32)
    return sgx, sgy, th


def test_raw_and_quantized_match_reference():
    jcfg, cfg = JConfig(height=64, width=96), SiftConfig(height=64, width=96)
    sgx, sgy, th = _inputs(7)
    raw_ref = np.asarray(jdescribe._bin_chunk_fast(
        jnp.asarray(sgx), jnp.asarray(sgy), jnp.asarray(th), jcfg, bf16=False))
    raw = describe._bin_chunk_fast(torch.from_numpy(sgx), torch.from_numpy(sgy),
                                   torch.from_numpy(th), cfg).numpy()
    np.testing.assert_allclose(raw, raw_ref, rtol=2e-5, atol=2e-6)

    q_ref = np.asarray(jdescribe.bin_descriptors(
        jnp.asarray(sgx), jnp.asarray(sgy), jnp.asarray(th), jcfg)).astype(int)
    q = describe.bin_descriptors(torch.from_numpy(sgx), torch.from_numpy(sgy),
                                 torch.from_numpy(th), cfg, chunk=128).numpy().astype(int)
    d = np.abs(q - q_ref)
    assert d.max() <= 1
    assert (d > 0).mean() < 1e-3


def test_wrap_edge_lands_on_bin_zero():
    """ob == NB (an angle that rounds to 2π) puts its weight on bin 0."""
    jcfg, cfg = JConfig(), SiftConfig()
    G2, NB = cfg.descriptor_grid ** 2, cfg.descriptor_bins
    sgx = np.ones((1, 2, G2), np.float32)
    sgy = np.full((1, 2, G2), -1e-9, np.float32)   # atan2 = -1e-9 -> 2π - 1e-9 -> 2π
    th = np.zeros((1, 2), np.float32)
    sgy[0, 1] = 1e-3                               # control: an ordinary angle near 0
    raw = describe._bin_chunk_fast(torch.from_numpy(sgx), torch.from_numpy(sgy),
                                   torch.from_numpy(th), cfg).numpy().reshape(2, 16, NB)
    raw_ref = np.asarray(jdescribe._bin_chunk_fast(
        jnp.asarray(sgx), jnp.asarray(sgy), jnp.asarray(th), jcfg, bf16=False)).reshape(2, 16, NB)
    np.testing.assert_allclose(raw, raw_ref, rtol=2e-5, atol=1e-7)
    assert raw[0, :, 0].sum() > 0 and not raw[0, :, 1:].any()
    assert raw[1, :, 0].sum() > 0
