"""``docs/api_torch.md``, the port's API page, as a doctest: every block
runs on the CPU (tier-1 does not collect ``docs/*.md`` itself)."""

import doctest
from pathlib import Path

DOC = Path(__file__).resolve().parents[1] / "docs" / "api_torch.md"


def test_api_torch_page_doctests():
    res = doctest.testfile(str(DOC), module_relative=False,
                           optionflags=doctest.ELLIPSIS, verbose=False)
    assert res.attempted > 40, res
    assert res.failed == 0, res
