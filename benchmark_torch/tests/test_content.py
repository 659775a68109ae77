"""The inputs: each mix's pool, made through its content module, holds the
bytes it held before content was found by name (digests pinned from the
harness at that time, on the CPU), and the Middlebury pairs are the stored
pair with independent noise from the seed."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from benchmark_torch.common.modules import BENCH_DIR, load_content
from benchmark_torch.common.traffic import make_inputs

CPU = torch.device("cpu")
SEED = 3_141_592_653  # more than 32 signed bits hold
# (calls, sha256 of the pool); "first_call" is the pool of one call at full
# size, which is the first call of the whole pool: a pool's calls are drawn
# from the generator in order
PINNED = {
    ("batch16_1024sq", "rehearsal"):
        (3, "dc8d63fdff9cf12d353376337b8755adf7140e28bbd9fd9c32f181643c630dc6"),
    ("batch16_1024sq", "first_call"):
        (1, "b8a71eafb7910849504e2f6bf839599ba532ced65e8223aa591c4acd1d44e4bd"),
    ("batch16_720p", "rehearsal"):
        (3, "dc8d63fdff9cf12d353376337b8755adf7140e28bbd9fd9c32f181643c630dc6"),
    ("batch16_720p", "first_call"):
        (1, "0fa5f86df3e0d8eefd42494f14f94f9219f33abf44e8248a53a0eb8054c82aaf"),
    ("stream_720p60", "rehearsal"):
        (4, "e07871c05f8f3a624c471fa93d0dc90a2e230e9debf0f8d89e10025370416503"),
}


def _digest(pool) -> str:
    h = hashlib.sha256()
    for x in pool:
        a = x.numpy() if isinstance(x, torch.Tensor) else x
        h.update(repr((type(x).__name__, a.dtype.str, a.shape)).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("mix_name,size", sorted(PINNED))
def test_each_mix_makes_the_pool_it_made_before(mix_name, size):
    with open(os.path.join(BENCH_DIR, "traffic", f"{mix_name}.json")) as f:
        mix = json.load(f)
    assert "content" not in mix  # lenna by default
    if size == "rehearsal":
        mix = {**mix, **mix["rehearsal"]}
    else:
        mix = {**mix, "pool_frames": mix["batch"]}
    pool = make_inputs(mix, SEED, CPU)
    assert (len(pool), _digest(pool)) == PINNED[mix_name, size]


PAIRS = load_content("middlebury_pairs")
PAIR_SHA256 = "67a16e738d68ef877d2eb1ce13f6f056c5bee434fd1237d2cb6522f92e5b4ec7"


def test_the_pairs_are_the_stored_luma_with_independent_noise_per_frame():
    x = PAIRS.make(torch.Generator().manual_seed(SEED % (1 << 64)), 3, 480, 640, CPU)
    assert x.dtype == torch.uint8 and tuple(x.shape) == (3, 2, 480, 640) and PAIRS.PLANES == 2
    base = torch.from_numpy(PAIRS.frames()).to(torch.int16)
    noise = x.to(torch.int16) - base
    assert int(noise.abs().max()) <= 4
    inside = ((base >= 4) & (base <= 251)).expand_as(noise)  # where no clamp cuts the noise
    values, counts = noise[inside].unique(return_counts=True)
    assert values.tolist() == list(range(-4, 5))
    share = counts.to(torch.float64) / counts.sum()
    assert float((share - 1 / 9).abs().max()) < 0.005
    # each frame of each item its own draw: two draws agree on about 1 / 9
    # of the pixels, and would on all of them if they were shared
    both = inside[:, 0] & inside[:, 1]
    for a, b in [((0, 0), (0, 1)), ((0, 0), (1, 0)), ((1, 1), (2, 1))]:
        same = (noise[a] == noise[b])[both[a[0]] & both[b[0]]].to(torch.float64).mean()
        assert abs(float(same) - 1 / 9) < 0.005, (a, b, float(same))


def test_the_same_seed_gives_the_same_pairs_and_another_seed_others():
    mix = {"content": "middlebury_pairs", "frame": [480, 640], "batch": 2, "io": "device",
           "pool_frames": 4}

    def pool(seed):
        return torch.stack(make_inputs(mix, seed, CPU))

    first = pool(SEED)
    assert tuple(first.shape) == (2, 2, 2, 480, 640)
    assert torch.equal(first, pool(SEED))
    assert not torch.equal(first, pool(SEED + 1))
    assert not torch.equal(first[0], first[1])  # nor are two calls alike


@pytest.mark.parametrize("frame", [(240, 320), (480, 641), (640, 480), (720, 1280)])
def test_the_pairs_are_not_resampled_to_another_frame(frame):
    with pytest.raises(ValueError, match="480 x 640"):
        PAIRS.make(torch.Generator().manual_seed(1), 1, *frame, CPU)


def test_the_stored_pair_is_pinned():
    # made once from the port's rounded BT.601 luma of assets/frame10.png and
    # frame11.png, and held here by its digest, so that neither a change to
    # the assets nor one to the program's PNG reader moves the traffic
    stored = PAIRS.frames()
    assert stored.dtype == np.uint8 and stored.shape == (2, 480, 640)
    assert hashlib.sha256(np.ascontiguousarray(stored).tobytes()).hexdigest() == PAIR_SHA256
