"""On the card, at a size a test run holds: the control (the reference in
float8 e4m3 in the program's place) reads at least three times what the
program reads on one of each cell's compared numbers, so a limit between
the two fails it. Decided inside the test whether there is a card."""

import pytest
import torch

from bench.tests import tiny

CELLS = ["qwen3-1.7b.decode-32k", "deepseek-moe-16b-l8.train-2k", "qwen3-1.7b.train-4k"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_separates_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = tiny.run(cell, device=torch.device("cuda", 0), control=True)
    sound, low = out["sound"], {k: c["value"] for k, c in out["checks"].items()}
    assert max(low[k] / max(sound[k], 1e-12) for k in low) >= 3.0, (sound, low)
