"""An autouse fixture for the test files whose runs write checkpoints and
weights (tens to hundreds of MB a test on the tiny towers): once a test
ends, the files of 1 MiB or more under its ``tmp_path`` go, so a whole run
of the tests keeps its temporary directories small.  Directories and
small files (logs, metrics) stay, so no later test is handed a path that
an earlier run's logger still holds.

Import it into a test module to apply it there::

    from tests.torch_outputs import drop_large_outputs  # noqa: F401
"""

import os

import pytest

LARGE = 1 << 20


@pytest.fixture(autouse=True)
def drop_large_outputs(tmp_path):
    yield
    for dirpath, _, names in os.walk(tmp_path):
        for name in names:
            path = os.path.join(dirpath, name)
            if not os.path.islink(path) and os.path.getsize(path) >= LARGE:
                os.remove(path)
