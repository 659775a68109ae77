"""PyTorch port: the motion ops against the benchmark's plain reference of
``motion_vga_hybrid`` (``benchmark_torch/reference/motion.py``), on the CPU
at small sizes with the configuration's own schedule (search 15, patch 5, 3
levels, a 9 x 9 median, 12 subpixel rounds): every search stage, the
median, the subpixel fit and the seed upscale bit for bit; the cell's whole
hybrid pyramid within its ``flow_off_share`` limit; the bfloat16 control
outside it."""

import json
import os

import pytest
import torch

from benchmark_torch.configs import motion_vga_hybrid as config
from benchmark_torch.content import middlebury_pairs
from benchmark_torch.reference import motion as ref
from oclcomputervision_tpu_torch.ops import motion as om

CPU = torch.device("cpu")
with open(os.path.join(os.path.dirname(config.__file__), "motion_vga_hybrid.json")) as f:
    SPEC = json.load(f)
SEARCH, PATCH = SPEC["search_size"], SPEC["patch_size"]
LIMIT = SPEC["limits"]["flow_off_share"]
BOUND = 8  # the seeded exact search's clamp in its stage test


def _noisy(base: torch.Tensor, seed: int) -> torch.Tensor:
    """Two items of the uint8 pair ``base`` [2, H, W], each frame given its
    own noise from [-4, 4]: uint8 [2, 2, H, W]."""
    g = torch.Generator().manual_seed(seed)
    noise = torch.randint(-4, 5, (2, *base.shape), generator=g, dtype=torch.int16)
    return torch.clamp(base.to(torch.int16) + noise, 0, 255).to(torch.uint8)


def _texture_48x64() -> torch.Tensor:
    """A random texture and the same texture moved by (2, -3) px."""
    g = torch.Generator().manual_seed(48)
    t = torch.randint(0, 256, (56, 72), generator=g, dtype=torch.int16)
    return torch.stack([t[4:52, 4:68], t[2:50, 7:71]])


def _pair_crop_96x128() -> torch.Tensor:
    """A 96 x 128 crop of the stored Middlebury pair."""
    return torch.from_numpy(middlebury_pairs.frames()[:, 200:296, 256:384].copy())


CASES = {"texture_48x64": _texture_48x64, "pair_96x128": _pair_crop_96x128}


@pytest.fixture(scope="module", params=sorted(CASES))
def pairs(request):
    return _noisy(CASES[request.param](), 18)


@pytest.fixture(scope="module")
def seed(pairs):
    """A float flow for the seeded stages and the float stages, with
    displacements past ``BOUND``."""
    g = torch.Generator().manual_seed(7)
    return (torch.randn(*pairs[:, 0].shape, 2, generator=g) * 6).clamp(-12, 12)


def _port_exact_seeded(f0, f1, seed):
    with pytest.warns(RuntimeWarning, match="clamps the seed base"):
        return om.estimate_motion_vector(f0, f1, SEARCH, PATCH, seed, "fixed", "exact",
                                         seed_bound=BOUND)


# each stage as (the port's op, the reference's) of (frame 0, frame 1, seed flow)
STAGES = {
    "exact": (lambda f0, f1, s: om.estimate_motion_vector(f0, f1, SEARCH, PATCH, method="exact"),
              lambda f0, f1, s: ref.exact(f0, f1, SEARCH, PATCH)),
    "exact_seeded": (_port_exact_seeded,
                     lambda f0, f1, s: ref.exact(f0, f1, SEARCH, PATCH, s, BOUND)),
    "fast": (lambda f0, f1, s: om.estimate_motion_vector(f0, f1, SEARCH, PATCH, method="fast"),
             lambda f0, f1, s: ref.fast(f0, f1, SEARCH, PATCH)),
    "fast_seeded": (lambda f0, f1, s: om.estimate_motion_vector(f0, f1, SEARCH, PATCH, s, "fixed",
                                                                "fast"),
                    lambda f0, f1, s: ref.fast(f0, f1, SEARCH, PATCH, s)),
    "median": (lambda f0, f1, s: om.median_filter_flow(s, SPEC["smooth"]),
               lambda f0, f1, s: ref.median_flow(s, SPEC["smooth"])),
    "subpixel": (lambda f0, f1, s: om.refine_flow_subpixel(f0, f1, s, PATCH),
                 lambda f0, f1, s: ref.fit(f0, f1, s, PATCH)),
    "upscale": (lambda f0, f1, s: om.upscale_mv(s, 2, "fixed"), lambda f0, f1, s: ref.upscale(s)),
}


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_each_stage_equals_the_reference_bit_for_bit(stage, pairs, seed):
    port, plain = STAGES[stage]
    f0, f1 = pairs[:, 0].contiguous(), pairs[:, 1].contiguous()
    got, want = port(f0, f1, seed), plain(f0, f1, seed)
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def reference_flows(pairs):
    return config.reference(SPEC, pairs)


def test_the_hybrid_pyramid_is_within_the_limit(pairs, reference_flows):
    flows = config.flatten(config.build(SPEC, CPU)(pairs))
    assert [tuple(f.shape) for f in flows] == [tuple(f.shape) for f in reference_flows]
    assert config.compare(SPEC, flows, reference_flows)["flow_off_share"] <= LIMIT


def test_the_bfloat16_control_is_outside_the_limit(pairs, reference_flows):
    flows = config.flatten(config.control(SPEC, CPU)(pairs))
    assert config.compare(SPEC, flows, reference_flows)["flow_off_share"] > LIMIT
