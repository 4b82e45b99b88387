"""Test-session settings: read-only Hypothesis files, synchronous JAX.

Hypothesis keeps its example database and its caches (constants,
unicode tables) under ``./.hypothesis``.  The examples there are
tracked: every run replays them, and by default it also deletes the
ones that no longer fail and writes new cache files beside them, so a
test run in the checkout leaves it changed.  Here the tracked examples
are replayed read-only, and Hypothesis's home is a path that cannot
hold a directory, so its best-effort caches are computed and never
written.

JAX's CPU client runs with synchronous dispatch.  On the CPU
``jnp.asarray`` of a 64-byte-aligned numpy array aliases its memory,
and the reference's paged decode loop (``repro.serving.decode``) hands
``lease.lengths`` to a step that is still running when
``append_paged`` advances those lengths in place; whether the step
reads the old or the new lengths then depends on the allocator and the
scheduler, and the exact-token parity tests of the paged path fail at
random.  Synchronous dispatch finishes each step before the host goes
on, so every step reads the lengths it was given.
"""

import os
from pathlib import Path

try:
    import jax
except ImportError:
    jax = None

if jax is not None:
    jax.config.update("jax_cpu_enable_async_dispatch", False)

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
