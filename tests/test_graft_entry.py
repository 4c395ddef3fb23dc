"""Driver-contract tests: entry() compiles and runs; dryrun_multichip
exercises the 8-device mesh."""

import pytest

pytestmark = pytest.mark.slow  # compile-heavy: excluded from the fast tier

import sys
from pathlib import Path

import jax
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def test_entry_compiles_and_steps():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert not bool(out.overflow)
    assert float(out.time) > 0


def test_dryrun_multichip_8():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)  # raises on failure


def test_dryrun_multichip_2():
    import __graft_entry__ as ge

    ge.dryrun_multichip(2)
