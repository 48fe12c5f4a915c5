"""The port's cavity + outline post-processing against the JAX package's,
on tests/test_post.py's random AOVs (including the flat-index wrap at row
ends): the outline exactly equal, the cavity within one 8-bit step."""
import numpy as np
import pytest
import torch

from rustray_tpu.config import PostProcessingConfig as JaxPostConfig
from rustray_tpu.render.post import run_post_processing as j_post
from test_post import _np_reference, _random_aovs
from rustray_tpu_torch.config import PostProcessingConfig
from rustray_tpu_torch.render.post import run_post_processing

torch.set_num_threads(1)

CONFIGS = {"outline": dict(outline=True), "cavity": dict(cavity=True),
           "both": dict(cavity=True, outline=True), "none": dict()}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_post_matches_jax(name, seed):
    image, normals, depth, ids = _random_aovs(np.random.default_rng(seed))
    ref = j_post(JaxPostConfig(**CONFIGS[name]), image, normals, depth, ids)
    cfg = PostProcessingConfig(**CONFIGS[name])
    got = run_post_processing(cfg, image, normals, depth, ids, device="cpu")
    assert got.dtype == np.uint8 and got.shape == image.shape
    diff = np.abs(got.astype(int) - ref.astype(int))
    if "cavity" in CONFIGS[name]:
        assert diff.max() <= 1
    else:
        np.testing.assert_array_equal(got, ref)
    # and against the literal transcription of src/post_processing.rs
    want = _np_reference(cfg, image, normals, ids)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_outline_wraps_at_row_ends():
    """A pixel at the end of a row sees the next row's first pixel as its
    right-hand neighbour (flat y*w+x fetch), as the reference does."""
    h, w = 4, 5
    ids = np.ones((h, w), np.int32)
    ids[2, 0] = 7          # flat neighbour of (1, 4)
    image = np.full((h, w, 3), 10, np.uint8)
    normals = np.zeros((h, w, 3), np.float32)
    got = run_post_processing(PostProcessingConfig(outline=True), image,
                              normals, normals[..., 0], ids, device="cpu")
    ref = j_post(JaxPostConfig(outline=True), image, normals,
                 normals[..., 0], ids)
    np.testing.assert_array_equal(got, ref)
    assert got[1, 4, 0] == 63     # one of four neighbours differs
