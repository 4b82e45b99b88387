"""Keep a test run from rewriting the tracked Hypothesis files.

Hypothesis keeps its example database and its caches (constants,
unicode tables) under ``./.hypothesis``.  The examples there are
tracked: every run replays them, and by default it also deletes the
ones that no longer fail and writes new cache files beside them, so a
test run in the checkout leaves it changed.  Here the tracked examples
are replayed read-only, and Hypothesis's home is a path that cannot
hold a directory, so its best-effort caches are computed and never
written.
"""

import os
from pathlib import Path

try:                      # the Hypothesis tests skip where it is missing
    from hypothesis import settings
    from hypothesis.configuration import set_hypothesis_home_dir
    from hypothesis.database import (DirectoryBasedExampleDatabase,
                                     ReadOnlyDatabase)
except ImportError:
    settings = None

if settings is not None:
    _EXAMPLES = Path(__file__).resolve().parent / ".hypothesis" / "examples"
    set_hypothesis_home_dir(os.devnull)
    settings.register_profile(
        "read_only_examples",
        database=ReadOnlyDatabase(DirectoryBasedExampleDatabase(_EXAMPLES)))
    settings.load_profile("read_only_examples")
