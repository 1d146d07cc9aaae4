"""The CUDA paged-attention kernel against its plain PyTorch version, on
the card.  This file imports neither JAX nor the reference, so it runs on
a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card each test skips (decided inside the test).  Tolerances:
1e-5 absolute in float32 (summation order), 2e-2 for bfloat16 outputs;
page masses 1e-5."""
import pytest
import torch

from repro_torch.kernels import paged_attention as tpa


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kv,window,softcap", [(40, 8, 0, 0.0),
                                                 (4, 4, 3, 0.0),
                                                 (8, 2, 0, 5.0),
                                                 (8, 1, 8, 5.0)])
def test_cuda_kernel_matches_plain(dtype, h, kv, window, softcap):
    """The CUDA kernel against its plain version on the card (ragged -1
    rows and a length-0 row included), and the launch counter."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run: python -m pytest -m gpu)")
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(h * 10 + kv)
    b, d, page, n, p_phys = 4, 128, 16, 16, 96
    q = torch.randn((b, h, d), generator=g, device=dev).to(dt)
    kp = torch.randn((p_phys, page, kv, d), generator=g, device=dev).to(dt)
    vp = torch.randn((p_phys, page, kv, d), generator=g, device=dev).to(dt)
    pt = torch.randperm(p_phys, generator=g, device=dev)[: b * n] \
        .reshape(b, n).to(torch.int32)
    pt[1, 10:] = -1
    ln = torch.tensor([n * page, 10 * page - 3, 0, 37], dtype=torch.int32,
                      device=dev)
    before = tpa.paged_attention.launches
    out, mass = tpa.paged_attention(q, kp, vp, pt, ln, window=window,
                                    softcap=softcap)
    torch.cuda.synchronize()
    assert tpa.paged_attention.launches == before + 1
    ref_o, ref_m = tpa.paged_attention_plain(q, kp, vp, pt, ln,
                                             window=window, softcap=softcap)
    tol = 2e-2 if dt == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), ref_o.float(), atol=tol, rtol=0)
    torch.testing.assert_close(mass, ref_m, atol=1e-5, rtol=0)
    active = ln > 0
    torch.testing.assert_close(mass.sum(dim=1)[active],
                               torch.ones(int(active.sum()), device=dev),
                               atol=1e-5, rtol=0)
