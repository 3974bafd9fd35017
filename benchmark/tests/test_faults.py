"""A run with the timed path broken underneath must come out not correct:
once for each fault a cell can have.  (No cell spans chips, so the fault
of an exchange between chips left out has no cell to break.)"""

import dataclasses

import jax
import numpy as np
import pytest

from conftest import run_cell
from lib import paths


@pytest.fixture
def fresh_jit():
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("name", ["rof.tiny", "multilabel.tiny"])
def test_step_that_returns_its_state_unchanged(tiny_root, on_cpu, capsys,
                                               monkeypatch, fresh_jit, name):
    from prost_tpu.backend import pdhg

    monkeypatch.setattr(pdhg, "pdhg_step", lambda problem, pg, pf, opts,
                        tols, s: dataclasses.replace(
                            s, iteration=s.iteration + 1))
    rc, out = run_cell(tiny_root, name, capsys)
    assert rc == 0 and out["correct"] is False


def _alter(monkeypatch, change):
    """Wrap both call paths so that ``change`` alters each answer where
    the solve produces it."""
    for cls in (paths.Single, paths.Batch):
        orig = cls.__call__

        def call(self, images, max_iters, span, orig=orig):
            done = orig(self, images, max_iters, span)
            done.answer = change(done.answer, images)
            return done

        monkeypatch.setattr(cls, "__call__", call)


@pytest.mark.parametrize("name", ["rof.tiny", "multilabel.tiny",
                                  "rof.tinybatch"])
def test_answer_altered_where_produced(tiny_root, on_cpu, capsys,
                                       monkeypatch, name):
    _alter(monkeypatch, lambda answer, images: answer * np.float32(0.98))
    rc, out = run_cell(tiny_root, name, capsys)
    assert rc == 0 and out["correct"] is False


def test_half_of_the_batch_left_out(tiny_root, on_cpu, capsys, monkeypatch):
    def half(answer, images):
        answer = answer.copy()
        answer[len(answer) // 2:] = images[len(answer) // 2:]
        return answer

    _alter(monkeypatch, half)
    rc, out = run_cell(tiny_root, "rof.tinybatch", capsys)
    assert rc == 0 and out["correct"] is False


@pytest.mark.parametrize("name", ["rof.tiny", "multilabel.tiny"])
def test_solve_stopped_early(tiny_root, on_cpu, capsys, monkeypatch, name):
    monkeypatch.setattr(paths, "_sopts", _capped(paths._sopts, 20))
    rc, out = run_cell(tiny_root, name, capsys)
    assert rc == 0 and out["correct"] is False


def _capped(sopts, cap):
    return lambda cfg, max_iters: sopts(cfg, min(max_iters, cap))
