"""The port's launch environment (``repro_torch.launch.env``) against the
contract ``tests/test_paged_kv.py:158-180`` holds the reference's to:
the snippet's export lines, ``validate`` reporting a changed variable,
and (the port running neither TensorFlow nor XLA) no ``XLA_FLAGS`` or
``TF_*`` key; and ``launch/serve --print-env`` printing the snippet
without building anything."""

import os

import pytest

pytest.importorskip("torch")

from repro.launch import env as jenv
from repro_torch.launch import env as tenv
from repro_torch.launch import serve as tserve


def test_recommended_env_and_shell_snippet():
    env = tenv.recommended_env()
    assert not [k for k in env if k == "XLA_FLAGS" or k.startswith("TF_")]
    assert env["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] == str(
        tenv.LARGE_ALLOC_THRESHOLD)
    if "LD_PRELOAD" in env:
        assert os.path.exists(env["LD_PRELOAD"])
    snippet = tenv.render_shell()
    for key, val in env.items():
        assert f'export {key}="{val}"' in snippet
    assert "XLA_FLAGS" not in snippet and "TF_CPP" not in snippet


def test_host_knobs_are_the_reference_ones():
    """tcmalloc's preload and threshold carry over unchanged: the port's
    keys are the reference's minus the TF/XLA ones, with the same
    values."""
    want = {k: v for k, v in jenv.recommended_env().items()
            if k not in ("XLA_FLAGS", "TF_CPP_MIN_LOG_LEVEL")}
    assert tenv.recommended_env() == want
    assert tenv.TCMALLOC_PATHS == jenv.TCMALLOC_PATHS


def test_env_validate_reports_divergence(monkeypatch):
    monkeypatch.setenv("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD", "1")
    diffs = {k: (want, have) for k, want, have in tenv.validate()}
    assert diffs["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] == (
        str(tenv.LARGE_ALLOC_THRESHOLD), "1")
    for key, val in tenv.recommended_env().items():
        monkeypatch.setenv(key, val)
    assert tenv.validate() == []
    # the reference's XLA and TF knobs are no divergence of the port's
    monkeypatch.setenv("XLA_FLAGS", "--xla_dump_to=/tmp/x")
    monkeypatch.setenv("TF_CPP_MIN_LOG_LEVEL", "0")
    assert tenv.validate() == []


def test_serve_print_env_prints_the_snippet_and_builds_nothing(
        monkeypatch, capsys):
    def boom(*a, **k):
        raise AssertionError("--print-env built the server")

    monkeypatch.setattr(tserve, "build", boom)
    monkeypatch.setattr(tserve, "serve", boom)
    assert tserve.main(["--print-env"]) == {}
    out = capsys.readouterr().out
    assert out.startswith(tenv.render_shell())
    assert "# current process:" in out
