"""The port's dry run on the two-pod mesh, 2 x 16 x 16 over a 512-rank
fake process group: every arch x shape cell is OK or SKIP as
``shape_applicable`` says (``test_torch_dryrun.py`` holds the 16 x 16
cells and what each row reports), each model cut to its prefix and one
period of its pattern."""
import pytest

from test_torch_dryrun import sweep
from repro_torch.configs import ARCH_IDS


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_cell_is_ok_or_skip_on_2x16x16(arch):
    sweep(arch, multi_pod=True)
