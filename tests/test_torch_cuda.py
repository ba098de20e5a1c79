"""The port's CUDA kernels against their plain PyTorch versions on the card.

Imports no JAX, so it runs where only the port is installed; every test
here needs an NVIDIA GPU and skips without one.  On the card:
    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from sjpeg_tpu_torch import constants as C
from sjpeg_tpu_torch import engine, state
from sjpeg_tpu_torch.huffman import k3_default_tables
from sjpeg_tpu_torch.ops import colorspace, sample_pack, stream_concat
from sjpeg_tpu_torch.params import EncoderParam

NB = {C.YUV_420: (4, 1, 1), C.YUV_444: (1, 1, 1), C.YUV_400: (1,)}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [C.YUV_420, C.YUV_444, C.YUV_400])
def test_kernels_match_plain_on_gpu(mode):
    """Both kernels == their plain versions on the same card inputs,
    including saturated chroma and words dropped past a small bucket."""
    _need_cuda()
    b, h, w = 3, 120, 200
    rgb = np.random.RandomState(14).randint(0, 256, (b, h, w, 3)).astype(
        np.uint8)
    rgb[0, :16, :16] = [0, 0, 255]
    param = EncoderParam(huffman_compress=False, adaptive_quantization=False,
                         yuv_mode=mode)
    t = state.tables_from_numpy(
        *engine._quant_arrays(engine._quant_matrices(param)),
        *engine._host_luts(k3_default_tables()), "cuda")
    blocks = colorspace.rgb_to_blocks(torch.from_numpy(rgb).cuda(), mode,
                                      w, h)
    sinter, dc, group = engine._interleave_samples(blocks, t[0], t[1],
                                                   NB[mode], b)
    words, bits = sample_pack.sample_pack(sinter, dc, group, *t)
    pw, pb = sample_pack.sample_pack_plain(sinter, dc, group, *t)
    assert torch.equal(bits, pb) and torch.equal(words, pw)
    for bucket in (64, 8192):
        out, tot = stream_concat.stream_concat(words, bits, b, bucket)
        po, pt = stream_concat.stream_concat_plain(words, bits, b, bucket)
        assert torch.equal(tot, pt) and torch.equal(out, po)


@pytest.mark.cuda
def test_encode_batch_gpu_matches_cpu():
    """The card's bytes == the CPU path's (plain versions) on a batch that
    is not a multiple of 16 in either dimension."""
    _need_cuda()
    rgb = np.random.RandomState(15).randint(0, 256, (2, 40, 24, 3)).astype(
        np.uint8)
    param = EncoderParam(huffman_compress=False, adaptive_quantization=False,
                         yuv_mode=C.YUV_420)
    assert (engine.encode_batch(rgb, param)
            == engine.encode_batch(rgb, param, device="cpu"))
