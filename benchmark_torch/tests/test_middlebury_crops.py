"""The rehearsal's pair content: the centre of the stored Middlebury pair,
cropped and never resampled, with the pairs' noise."""

import pytest
import torch

from benchmark_torch.common.modules import load_content

CROPS, PAIRS = load_content("middlebury_crops"), load_content("middlebury_pairs")


def test_a_crop_is_the_centre_of_the_stored_pair_with_its_noise():
    x = CROPS.make(torch.Generator().manual_seed(3), 3, 96, 128, torch.device("cpu"))
    assert x.dtype == torch.uint8 and tuple(x.shape) == (3, 2, 96, 128) and CROPS.PLANES == 2
    centre = torch.from_numpy(PAIRS.frames()[:, 192:288, 256:384].copy()).to(torch.int16)
    noise = x.to(torch.int16) - centre
    assert int(noise.abs().max()) <= PAIRS.NOISE
    assert not torch.equal(noise[0], noise[1]) and not torch.equal(noise[0, 0], noise[0, 1])
    again = CROPS.make(torch.Generator().manual_seed(3), 3, 96, 128, torch.device("cpu"))
    assert torch.equal(x, again)


@pytest.mark.parametrize("frame", [(481, 640), (480, 641), (0, 64)])
def test_a_crop_is_never_larger_than_the_pair(frame):
    with pytest.raises(ValueError, match="480 x 640"):
        CROPS.make(torch.Generator().manual_seed(1), 1, *frame, torch.device("cpu"))
