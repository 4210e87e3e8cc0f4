"""The port's dry run on one pod, 16 x 16 over a 256-rank fake process
group: every arch x shape cell is OK or SKIP as ``shape_applicable``
says (``test_torch_dryrun.py`` holds what each row reports), each model
cut to its prefix and one period of its pattern."""
import pytest

from test_torch_dryrun import sweep
from repro_torch.configs import ARCH_IDS


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_cell_is_ok_or_skip_on_16x16(arch):
    sweep(arch, multi_pod=False)
