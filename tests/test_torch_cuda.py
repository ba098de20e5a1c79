"""The port's CUDA kernels against their plain PyTorch versions on the card,
and the card's bytes against the CPU path's.

Imports no JAX, so it runs where only the port is installed; every test
here needs an NVIDIA GPU and skips without one.  On the card:
    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

from unittest import mock

import numpy as np
import pytest
import torch

from chip_smoke import random_streams
from sjpeg_tpu_torch import constants as C
from sjpeg_tpu_torch import engine, state
from sjpeg_tpu_torch.huffman import k3_default_tables, trellis_cost_lens
from sjpeg_tpu_torch.ops import (colorspace, fdct, huffman_device,
                                 merge_codesizes, quant_pack, sample_pack,
                                 stream_concat, trellis, vlc, vlc_pack)
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


def _vlc_state(n_images, per_img, seed):
    """int32 VLC fields, DC codes and groups of random quantized blocks
    (zero runs past 16, dense rows), image-major."""
    n = n_images * per_img
    rng = np.random.RandomState(seed)
    q = rng.randint(-1500, 1501, (n, 64)) * (rng.rand(n, 64) < 0.2)
    q[::5, 1:63] = 0
    q[1::5, 1:] = rng.randint(-2, 3, (len(q[1::5]), 63))
    rl = vlc.run_levels(torch.from_numpy(q).cuda(), torch.int32)
    dc = vlc.dc_diff_codes(torch.from_numpy(
        rng.randint(-1023, 1024, n)).cuda(), n_images)
    group = torch.from_numpy((np.arange(n) % 6 >= 4).astype(np.int32)).cuda()
    return rl, dc, group


@pytest.mark.cuda
@pytest.mark.parametrize("n_images,per_img", [(3, 700), (8, 48), (2, 1024)])
@pytest.mark.parametrize("per_image", [False, True])
def test_vlc_pack_matches_plain_on_gpu(n_images, per_img, per_image):
    """vlc_pack == vlc_pack_plain with shared or per-image LUTs, where a
    CTA's 128 rows straddle two images (700), many images (48), or none
    (1024)."""
    _need_cuda()
    rl, dc, group = _vlc_state(n_images, per_img, 17)
    freqs = engine._grouped_stats(rl, dc, group, n_images)
    dcl, acl, _, _ = huffman_device.luts_and_desc_from_freqs(*freqs)
    if not per_image:
        dcl, acl = dcl[-1].contiguous(), acl[-1].contiguous()
    args = (rl["run"], rl["size"], rl["code"], dc, group, dcl, acl)
    words, bits = vlc_pack.vlc_pack(*args)
    pw, pb = vlc_pack.vlc_pack_plain(*args)
    assert torch.equal(bits, pb) and torch.equal(words, pw)


@pytest.mark.cuda
@pytest.mark.parametrize("per_image", [False, True])
@pytest.mark.parametrize("runs", ["run_levels", "longer"])
def test_vlc_pack_full_pieces_on_gpu(per_image, runs):
    """vlc_pack == vlc_pack_plain with LUTs of 32-bit pieces, where rows
    with every position coded fill all 2,048 bits of the shared row the
    stream is written over; and with runs longer than the positions they
    skip, whose ZRLs carry the stream past fields still to be read (read
    again from global memory).  Shared LUTs, or per-image sets over
    images of 48 blocks."""
    _need_cuda()
    n_images, per_img = 8, 48
    n = n_images * per_img
    rng = np.random.RandomState(32)
    q = rng.randint(-2047, 2048, (n, 64)) * (rng.rand(n, 64) < 0.5)
    q[::3] = rng.choice([-1, 1], (len(q[::3]), 64)) * rng.randint(
        1, 2048, (len(q[::3]), 64))
    rl = vlc.run_levels(torch.from_numpy(q).cuda(), torch.int32)
    run = rl["run"]
    if runs == "longer":
        run = torch.where(rl["size"] > 0, torch.from_numpy(rng.randint(
            0, 64, (n, 64)).astype(np.int32)).cuda(), 0)
    dc = vlc.dc_diff_codes(torch.from_numpy(
        rng.randint(-2047, 2048, n)).cuda(), n_images)
    group = torch.from_numpy((np.arange(n) % 6 >= 4).astype(np.int32)).cuda()
    luts = _full_piece_luts(rng)
    if per_image:
        luts = tuple(np.stack([a] * n_images) for a in luts)
    dcl, acl = state.arrays_to_device(*luts, device="cuda")
    args = (run, rl["size"], rl["code"], dc, group, dcl, acl)
    words, bits = vlc_pack.vlc_pack(*args)
    pw, pb = vlc_pack.vlc_pack_plain(*args)
    assert torch.equal(bits, pb) and torch.equal(words, pw)
    if runs == "run_levels":
        assert int(bits.max()) == 2048


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_image_4032x3024", "images_of_48",
                                  "overflow", "all_empty", "full_rows"])
def test_stream_concat_edges_on_gpu(case):
    """stream_concat == stream_concat_plain where its chunked scan and its
    placement meet their edges: 285,768 blocks in one image (1,117 scan
    chunks), images shorter than a chunk, totals past the bucket, all
    blocks empty, every block 2,048 bits; lengths mix empty, short and
    full streams, so offsets take every residue mod 32."""
    _need_cuda()
    n_images, per_img, bucket = {
        "one_image_4032x3024": (1, 285_768, 285_768 * 64),
        "images_of_48": (64, 48, 4096), "overflow": (4, 700, 64),
        "all_empty": (8, 700, 4096), "full_rows": (3, 700, 700 * 64)}[case]
    n = n_images * per_img
    rng = np.random.RandomState(33)
    lens = rng.randint(0, 400, n)
    lens[rng.rand(n) < 0.2] = 0
    lens[rng.rand(n) < 0.02] = 2048
    if case == "all_empty":
        lens[:] = 0
    elif case == "full_rows":
        lens[:] = 2048
    words = torch.from_numpy(random_streams(rng, lens)).cuda()
    bits = torch.from_numpy(lens.astype(np.int32)).cuda()
    out, tot = stream_concat.stream_concat(words, bits, n_images, bucket)
    po, pt = stream_concat.stream_concat_plain(words, bits, n_images, bucket)
    assert torch.equal(tot, pt) and torch.equal(out, po)
    assert (int(pt.max()) > bucket * 32) == (case == "overflow")


def _freq_rows(size, width, seed):
    """Frequency rows with ties, an empty row, one and two symbols,
    Fibonacci rows (codes past 16 and past 32 bits), values near 2^30 and
    sums that wrap past 2^31 (the kernel's 64-bit keys)."""
    rng = np.random.RandomState(seed)
    fib = [1, 1]
    while len(fib) < 40:
        fib.append(fib[-1] + fib[-2])
    rows = [rng.randint(0, 50, size), np.where(rng.rand(size) < 0.5, 7, 0),
            np.zeros(size, np.int64)]
    for picks, vals in [(1, [12345]), (2, [3, 3]), (24, fib[:24]),
                        (40, fib), (3, [(1 << 30) - 1, 1 << 29, 5])]:
        r = np.zeros(size, np.int64)
        m = min(picks, size)
        r[rng.permutation(size)[:m]] = vals[:m]
        rows.append(r)
    for _ in range(4):
        r = np.zeros(size, np.int64)
        n = rng.randint(3, size + 1)
        r[rng.permutation(size)[:n]] = rng.randint(1 << 29, 1 << 31, n)
        rows.append(r)
    out = np.zeros((len(rows), width), np.int32)
    out[:, :size] = np.stack(rows)
    return torch.from_numpy(out).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("size,width", [(12, 16), (256, 320)])
def test_merge_codesizes_matches_plain_on_gpu(size, width):
    """The table kernel (merge_codesizes) builds the same LUTs, code-length
    counts, symbol counts and DHT order as optimal_code_luts_plain from
    adversarial rows, in one launch and with no host read."""
    _need_cuda()
    freq = _freq_rows(size, width, 18)
    launches = merge_codesizes.optimal_tables.launches
    reads = huffman_device.optimal_code_luts.any_reads
    got = huffman_device.optimal_code_luts(freq, size, with_syms=True)
    assert merge_codesizes.optimal_tables.launches == launches + 1
    assert huffman_device.optimal_code_luts.any_reads == reads
    want = huffman_device.optimal_code_luts_plain(freq.cpu(), size,
                                                  with_syms=True)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    on_card = huffman_device.optimal_code_luts_plain(freq, size,
                                                     with_syms=True)
    for g, w in zip(got, on_card):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("nb_tables", [1, 2])
def test_table_build_is_one_launch_on_gpu(nb_tables):
    """luts_and_desc_from_freqs builds the DC and the AC tables of a batch
    in one merge_codesizes launch, equal to the CPU path's."""
    _need_cuda()
    dc = _freq_rows(12, 12, 19)[:12]
    ac = _freq_rows(256, 256, 20)[:12]
    launches = merge_codesizes.optimal_tables.launches
    got = huffman_device.luts_and_desc_from_freqs(dc.reshape(6, 2, 12),
                                                  ac.reshape(6, 2, 256),
                                                  nb_tables)
    assert merge_codesizes.optimal_tables.launches == launches + 1
    want = huffman_device.luts_and_desc_from_freqs(
        dc.cpu().reshape(6, 2, 12), ac.cpu().reshape(6, 2, 256), nb_tables)
    flat = huffman_device.desc_to_flat(got[2], got[3])
    assert torch.equal(flat.cpu(), huffman_device.desc_to_flat(want[2],
                                                               want[3]))
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("share", [False, True])
def test_method4_gpu_matches_cpu(share):
    """Method 4 on the card == the CPU path's bytes, per-image and shared
    statistics, on a batch that is not a multiple of 16 either way."""
    _need_cuda()
    rgb = np.random.RandomState(19).randint(0, 256, (2, 40, 24, 3)).astype(
        np.uint8)
    param = EncoderParam(yuv_mode=C.YUV_420)
    assert (engine.encode_batch(rgb, param, share_statistics=share)
            == engine.encode_batch(rgb, param, share_statistics=share,
                                   device="cpu"))


def _trellis_inputs(n_images, per_img, per_image_mats, per_image_rates,
                    seed):
    """trellis_quantize's arguments, int32 on the card: coefficients
    with full-range, flat and zero rows; matrices ([2, 64] or [B, 2, 64],
    qualities 30/75/100 in turn); groups; rate tables ([2, 256] K.3 or
    [B, 2, 256] variants)."""
    n = n_images * per_img
    rng = np.random.RandomState(seed)
    c = rng.randint(-40, 40, (n, 64)) * rng.choice([0, 1, 1, 1, 16, 64],
                                                   (n, 64))
    k = n // 8
    c[:k] = rng.randint(-16384, 16385, (k, 64))
    c[k:2 * k] = rng.choice([8, 40, 160], (k, 1))
    c[2 * k:3 * k] = 0
    group = (np.arange(n) % 6 >= 4).astype(np.int32)
    quals = [(30, 75, 100)[i % 3] for i in range(n_images)]
    per_qms = [engine._quant_matrices(EncoderParam(quality=q))
               for q in (quals if per_image_mats else [75])]
    mats = [np.stack([[qms[g][key] for g in range(2)] for qms in per_qms])
            for key in ("iquant", "bias", "quant")]
    if not per_image_mats:
        mats = [m[0] for m in mats]
    lens = np.array(trellis_cost_lens())
    if per_image_rates:
        lens = np.stack([(lens, lens[::-1], np.minimum(lens + 1, 16))[i % 3]
                         for i in range(n_images)])
    return state.arrays_to_device(c, *mats, group, lens, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_images,per_img", [(3, 700), (8, 48), (2, 1024)])
@pytest.mark.parametrize("sets", ["shared", "mats", "rates", "both"])
def test_trellis_matches_plain_on_gpu(n_images, per_img, sets):
    """trellis_quantize == trellis_quantize_plain with shared or per-image
    matrices and rate tables, where a CTA's 128 rows straddle two images
    (700), many images (48), or none (1024)."""
    _need_cuda()
    args = _trellis_inputs(n_images, per_img, sets in ("mats", "both"),
                           sets in ("rates", "both"), 20)
    got = trellis.trellis_quantize(*args, n_images=n_images)
    want = trellis.trellis_quantize_plain(*args, n_images=n_images)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("share", [False, True])
def test_method7_gpu_matches_cpu(share):
    """Method 7 (trellis) on the card == the CPU path's bytes."""
    _need_cuda()
    rgb = np.random.RandomState(21).randint(0, 256, (2, 40, 24, 3)).astype(
        np.uint8)
    param = EncoderParam(yuv_mode=C.YUV_420, use_trellis=True)
    assert (engine.encode_batch(rgb, param, share_statistics=share)
            == engine.encode_batch(rgb, param, share_statistics=share,
                                   device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("n_images,per_img", [(3, 700), (8, 48), (2, 1024)])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_sample_pack_per_image_matches_plain_on_gpu(n_images, per_img,
                                                    dtype):
    """sample_pack with per-image quantizers and LUTs == its plain version,
    where a CTA's 128 rows straddle two images (700), many images (48), or
    none (1024), with int16 and int32 samples (chroma +128 included)."""
    _need_cuda()
    n = n_images * per_img
    rng = np.random.RandomState(22)
    samples = rng.randint(-128, 129, (n, 64))
    samples[::7] //= 16                                  # smoother rows
    rl, dc, group = _vlc_state(n_images, per_img, 23)
    dcl, acl, _, _ = huffman_device.luts_and_desc_from_freqs(
        *engine._grouped_stats(rl, dc, group, n_images))
    per_qms = [engine._quant_matrices(EncoderParam(quality=q))
               for q in ((30, 75, 100, 90)[i % 4] for i in range(n_images))]
    iq3, ib3 = state.arrays_to_device(
        *(np.stack(a) for a in zip(*map(engine._quant_arrays, per_qms))),
        device="cuda")
    args = (torch.from_numpy(samples).to("cuda", dtype), dc, group, iq3,
            ib3, dcl, acl)
    before = sample_pack.sample_pack.per_image_launches
    words, bits = sample_pack.sample_pack(*args)
    assert sample_pack.sample_pack.per_image_launches == before + 1
    pw, pb = sample_pack.sample_pack_plain(*args)
    assert torch.equal(bits, pb) and torch.equal(words, pw)


@pytest.mark.cuda
@pytest.mark.parametrize("per_img", [20, 127])
@pytest.mark.parametrize("sets", ["shared", "both"])
def test_trellis_small_images_and_full_rows_on_gpu(per_img, sets):
    """trellis_quantize == its plain version over images of 20 blocks
    (seven matrix and rate-table sets in one CTA's 128 rows) and of 127,
    on rows with every AC position coded among all-zero, flat and
    full-range rows."""
    _need_cuda()
    n_images = 16
    args = list(_trellis_inputs(n_images, per_img, sets == "both",
                                sets == "both", 29))
    rng = np.random.RandomState(30)
    n = n_images * per_img
    full = rng.randint(3000, 16385, (n, 64)) * rng.choice([-1, 1], (n, 64))
    args[0][::4] = torch.from_numpy(full[::4]).to("cuda", torch.int32)
    got = trellis.trellis_quantize(*args, n_images=n_images)
    want = trellis.trellis_quantize_plain(*args, n_images=n_images)
    assert torch.equal(got, want)
    assert (got[::4, 1:] != 0).sum(1).max() > 40


def _full_piece_luts(rng):
    """[2, 16] DC and [2, 256] AC LUTs whose every piece is 32 bits (code
    lengths 32 - size): a block with every position coded fills all
    2,048 bits of its word row, the longest stream there is (at most 64
    pieces of at most 32 bits)."""
    size = np.arange(256) & 15
    dcl = (rng.randint(0, 1 << 16, 16) << 16) | (32 - np.arange(16))
    acl = (rng.randint(0, 1 << 16, 256) << 16) | (32 - size)
    return np.stack([dcl, dcl]), np.stack([acl, acl])


@pytest.mark.cuda
@pytest.mark.parametrize("per_image", [False, True])
@pytest.mark.parametrize("luts", ["k3", "full_pieces"])
def test_sample_pack_longest_streams_on_gpu(per_image, luts):
    """sample_pack == its plain version on full int16-range samples at
    q100 (the longest K.3 streams), and with LUTs of 32-bit pieces whose
    streams fill all 64 words; shared tables, or per-image sets over
    images of 20 blocks, seven sets in one CTA's 128 rows."""
    _need_cuda()
    n_images, per_img = 16, 20
    n = n_images * per_img
    rng = np.random.RandomState(31)
    samples = torch.from_numpy(rng.randint(-32768, 32768, (n, 64))).to(
        "cuda", torch.int16)
    dc = vlc.dc_diff_codes(torch.from_numpy(
        rng.randint(-2047, 2048, n)).cuda(), n_images)
    group = torch.from_numpy((np.arange(n) % 6 >= 4).astype(np.int32)).cuda()
    quants = [engine._quant_arrays(engine._quant_matrices(
        EncoderParam(quality=q))) for q in (100, 95, 90, 85)]
    lut_arrays = (engine._host_luts(k3_default_tables()) if luts == "k3"
                  else _full_piece_luts(rng))
    if per_image:
        arrays = (*(np.stack([quants[i % 4][k] for i in range(n_images)])
                    for k in range(2)),
                  *(np.stack([a] * n_images) for a in lut_arrays))
    else:
        arrays = (*quants[0], *lut_arrays)
    t = state.tables_from_numpy(*arrays, "cuda")
    words, bits = sample_pack.sample_pack(samples, dc, group, *t)
    pw, pb = sample_pack.sample_pack_plain(samples, dc, group, *t)
    assert torch.equal(bits, pb) and torch.equal(words, pw)
    if luts == "full_pieces":
        assert int(bits.max()) == 2048


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(),                                          # size, device loop
    dict(target_mode=2, target_value=33.0),          # PSNR, device loop
    dict(passes=10),                                 # pass by pass
    dict(use_trellis=True),                          # trellis rate tables
    dict(huffman_compress=False, adaptive_quantization=False),
])
def test_search_gpu_matches_cpu(kw):
    """The batched search on the card == the CPU path's bytes."""
    _need_cuda()
    rgb = np.random.RandomState(24).randint(0, 256, (2, 40, 24, 3)).astype(
        np.uint8)
    base = dict(quality=90, yuv_mode=C.YUV_420, target_mode=1,
                target_value=900.0, passes=5, tolerance=2.0)
    param = EncoderParam(**dict(base, **kw))
    before = sample_pack.sample_pack.per_image_launches
    got = engine.encode_batch(rgb, param)
    if param.passes <= 8 and not param.use_trellis and kw.get(
            "target_mode", 1) == 1:
        assert sample_pack.sample_pack.per_image_launches > before
    assert got == engine.encode_batch(rgb, param, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 300, 4096])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_fdct_matches_plain_on_gpu(n, dtype):
    """fdct_blocks == fdct_blocks_plain on the card, from int16 and int32
    samples, with a ragged last CTA (300) and the full int16 range."""
    _need_cuda()
    rng = np.random.RandomState(25)
    blocks = rng.randint(-128, 129, (n, 64))
    blocks[::5] = rng.randint(-32768, 32768, blocks[::5].shape)
    x = torch.from_numpy(blocks).to("cuda", dtype)
    before = fdct.fdct_blocks.launches
    got = fdct.fdct_blocks(x)
    assert fdct.fdct_blocks.launches == before + 1
    assert torch.equal(got, fdct.fdct_blocks_plain(x))
    with pytest.raises(ValueError):
        fdct.fdct_blocks(x.t())                 # not [N, 64] contiguous


@pytest.mark.cuda
@pytest.mark.parametrize("q", [30, 75, 100])
def test_quant_pack_matches_plain_on_gpu(q):
    """quant_pack == quant_pack_plain on the coefficients of a 4:2:0 image
    with 700 blocks (a CTA's rows end mid-MCU) and of int16-range blocks."""
    _need_cuda()
    rng = np.random.RandomState(26)
    rgb = rng.randint(0, 256, (1, 112, 160, 3)).astype(np.uint8)
    blocks = colorspace.rgb_to_blocks(torch.from_numpy(rgb).cuda(),
                                      C.YUV_420, 160, 112)
    coeffs = [fdct.fdct_blocks_plain(b) for b in blocks]
    coeffs[0][::9] = torch.from_numpy(rng.randint(
        -32768, 32768, coeffs[0][::9].shape)).to("cuda", torch.int32)
    param = EncoderParam(quality=q, yuv_mode=C.YUV_420)
    t = state.tables_from_numpy(
        *engine._quant_arrays(engine._quant_matrices(param)),
        *engine._host_luts(k3_default_tables()), "cuda")
    cinter, dc, group = engine._interleave_coeffs(coeffs, t[0], t[1],
                                                  NB[C.YUV_420])
    assert cinter.shape[0] == 420
    before = quant_pack.quant_pack.launches
    words, bits = quant_pack.quant_pack(cinter, dc, group, *t)
    assert quant_pack.quant_pack.launches == before + 1
    pw, pb = quant_pack.quant_pack_plain(cinter, dc, group, *t)
    assert torch.equal(bits, pb) and torch.equal(words, pw)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(huffman_compress=False, adaptive_quantization=False),  # sample_pack
    dict(huffman_compress=False),                               # quant_pack
    dict(),
    dict(use_trellis=True),
    dict(target_mode=1, target_value=900.0, passes=5),
    dict(huffman_compress=False, adaptive_quantization=False, target_mode=2,
         target_value=33.0, passes=5),
])
def test_encode_rgb_gpu_matches_cpu(kw):
    """The single-image path on the card == the CPU path's bytes, and
    encode_gray / encode_yuv (quant_pack for method 0) too."""
    _need_cuda()
    rgb = np.random.RandomState(27).randint(0, 256, (40, 24, 3)).astype(
        np.uint8)
    param = EncoderParam(yuv_mode=C.YUV_420, quality=85, **kw)
    assert (engine.encode_rgb(rgb, param)
            == engine.encode_rgb(rgb, param, device="cpu"))
    planes = (rgb[..., 0].copy(), rgb[::2, ::2, 1].copy(),
              rgb[::2, ::2, 2].copy())
    assert (engine.encode_yuv(*planes, True, param)
            == engine.encode_yuv(*planes, True, param, device="cpu"))
    assert (engine.encode_gray(planes[0], param)
            == engine.encode_gray(planes[0], param, device="cpu"))


@pytest.mark.cuda
def test_encode_pipelined_two_streams_on_gpu():
    """encode_pipelined at depth 2 runs its batches on two worker streams,
    not the default stream, and yields encode_batch's bytes in order."""
    _need_cuda()
    batches = [np.random.RandomState(28 + i).randint(
        0, 256, (3, 64, 48, 3)).astype(np.uint8) for i in range(4)]
    param = EncoderParam(yuv_mode=C.YUV_420)
    seen = set()
    wrapped = engine.encode_batch

    def spy(*a, **k):
        seen.add(torch.cuda.current_stream().cuda_stream)
        return wrapped(*a, **k)

    with mock.patch.object(engine, "encode_batch", spy):
        got = list(engine.encode_pipelined(batches, param, depth=2))
    assert len(seen) == 2
    assert torch.cuda.default_stream().cuda_stream not in seen
    assert got == [engine.encode_batch(b, param) for b in batches]
