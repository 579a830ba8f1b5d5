"""Which card a process of the port binds (ROADMAP C.4), on the CPU with
``torch.cuda`` replaced by a four-card stand-in.

- ``resolve_device("cuda")`` is the current device without a launcher,
  ``cuda:{LOCAL_RANK}`` under one, and raises for a LOCAL_RANK past the
  card count; an explicit index is kept.
- ``init_multihost`` pins that card before it forms the NCCL group.
- ``cli._train_fold_parallel`` writes summary.csv on rank 0 alone, also
  when the folds do not split over the ranks.
"""
import os
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from hipt_abmil_atec23_tpu_torch import cli
from hipt_abmil_atec23_tpu_torch.device import resolve_device
from hipt_abmil_atec23_tpu_torch.parallel import multihost

CARDS = 4


@pytest.fixture
def cards(monkeypatch):
    """Four visible cards, card ``current`` current; ``set_device`` calls
    recorded in ``pinned``."""
    state = types.SimpleNamespace(current=0, pinned=[])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: CARDS)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: state.current)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: state.pinned.append(torch.device(d)))
    for k in ("LOCAL_RANK", "RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    return state


def test_without_a_launcher_cuda_is_the_current_card(cards):
    assert resolve_device("cuda") == torch.device("cuda", 0)
    cards.current = 2
    assert resolve_device("cuda") == torch.device("cuda", 2)
    assert resolve_device(torch.device("cuda")) == torch.device("cuda", 2)


@pytest.mark.parametrize("local_rank", range(CARDS))
def test_local_rank_names_the_card(cards, monkeypatch, local_rank):
    monkeypatch.setenv("LOCAL_RANK", str(local_rank))
    assert resolve_device("cuda") == torch.device("cuda", local_rank)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)  # explicit
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("local_rank", [CARDS, CARDS + 3, -1])
def test_local_rank_past_the_cards_raises(cards, monkeypatch, local_rank):
    """No wrap round to another card, no CPU in its place."""
    monkeypatch.setenv("LOCAL_RANK", str(local_rank))
    with pytest.raises(RuntimeError, match="names no card"):
        resolve_device("cuda")


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")


def test_init_multihost_pins_the_launchers_card(cards, monkeypatch):
    """Under a launcher's environment every rank pins its own card before
    the NCCL group (and so any DeviceMesh) exists."""
    calls = []

    def init_process_group(backend, **kw):
        calls.append((backend, kw, list(cards.pinned)))

    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", init_process_group)
    for rank in range(CARDS):
        monkeypatch.setenv("RANK", str(rank))
        monkeypatch.setenv("WORLD_SIZE", str(CARDS))
        monkeypatch.setenv("LOCAL_RANK", str(rank))
        assert multihost.init_multihost(device="cuda") == CARDS
    for rank, (backend, kw, pinned) in enumerate(calls):
        assert backend == "nccl"
        assert kw == {"init_method": "env://", "world_size": CARDS,
                      "rank": rank}
        assert pinned[-1] == torch.device("cuda", rank)
    assert len(cards.pinned) == CARDS


def test_init_multihost_refuses_a_rank_without_a_card(cards, monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: pytest.fail("group formed"))
    monkeypatch.setenv("RANK", "4")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("LOCAL_RANK", "4")
    with pytest.raises(RuntimeError, match="names no card"):
        multihost.init_multihost(device="cuda")
    assert cards.pinned == []


@pytest.mark.parametrize("rank", [0, 1])
def test_fold_parallel_summary_on_rank_zero_alone(monkeypatch, tmp_path,
                                                  rank):
    """k = 3 folds over 2 ranks: no mesh, every rank trains every fold,
    and only rank 0 writes summary.csv."""
    from hipt_abmil_atec23_tpu_torch.engine import experiment
    from hipt_abmil_atec23_tpu_torch.parallel import fold_parallel
    from hipt_abmil_atec23_tpu_torch.utils.config import ExperimentConfig
    cfg = ExperimentConfig.from_dict({"results_dir": str(tmp_path),
                                      "train": {"k": 3}})
    meshes = []

    def train(cfg, folds, counts, mesh, device):
        meshes.append(mesh)
        return types.SimpleNamespace(summary={"val_auc": np.ones(3)})

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(experiment, "make_fold_datasets",
                        lambda *a: None)
    monkeypatch.setattr(fold_parallel, "train_folds_parallel", train)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: rank)
    manifest = types.SimpleNamespace(class_counts=lambda: np.array([5, 5]))
    cli._train_fold_parallel(cfg, manifest, None, torch.device("cpu"))
    assert meshes == [None]
    written = os.path.exists(tmp_path / "summary.csv")
    assert written == (rank == 0)
