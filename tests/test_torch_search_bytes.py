"""The rest of test_torch_search.py's byte cases (trellis, PSNR, gray,
NV12, ten passes, the bucket overflow), in a file of their own so that
--dist loadfile runs them on a second worker: encode_batch with passes > 1
and a target, on device="cpu", == sjpeg_tpu.engine.encode_batch, byte for
byte."""

import pytest

from test_torch_search import BYTES_FILE_CASES, check_search_bytes
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("name", BYTES_FILE_CASES)
def test_search_bytes_match_jax(name):
    """encode_batch (and the planar entry points) with passes > 1 and a
    target == sjpeg_tpu.engine.encode_batch, byte for byte."""
    check_search_bytes(name)
