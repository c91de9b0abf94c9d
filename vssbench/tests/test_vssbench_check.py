"""The check that decides `correct`: a sound run of the port passes; the
control (the reference in TF32 in the program's place) and each fault
the cells can have, planted under a full run, fail it. At the tiny sizes
of `tiny.py`, on the CPU (the port's plain versions)."""
import time

import numpy as np
import pytest
import torch

from vssbench import cell
from vssbench.control import SYSTEMS, BlockSkipped, ControlSystem
from vssbench.system import PortSystem

from .tiny import make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return make_root(tmp_path_factory.mktemp("tiny"))


def run(root, name, make_system=cell.port_system, seed=2**31 + 77):
    return cell.run_cell(name, seed, 0.2, False, "cpu", time.perf_counter(), root=root,
                         make_system=make_system)


def numbers(r):
    return {k: v["value"] for k, v in r["check"].items()}


class HalfBatch(PortSystem):
    """Answers the first half of each batch and repeats it for the rest."""

    def search(self, q, k, ef):
        h = q.shape[0] // 2
        d, i = super().search(q[:h], k, ef)
        return np.concatenate([d, d[: q.shape[0] - h]]), np.concatenate([i, i[: q.shape[0] - h]])

    def scan_search(self, q, k):
        h = q.shape[0] // 2
        d, i = super().scan_search(q[:h], k)
        return np.concatenate([d, d[: q.shape[0] - h]]), np.concatenate([i, i[: q.shape[0] - h]])


class Altered(PortSystem):
    """One answer altered where it is produced: the first query's best id
    is swapped for its last (a live row, reported at the best's distance)."""

    def search(self, q, k, ef):
        d, i = super().search(q, k, ef)
        i = i.copy()
        i[0, 0] = i[0, -1] + 1 if i[0, -1] + 1 not in i[0] else i[0, -1] + 2
        return d, i

    def scan_search(self, q, k):
        d, i = super().scan_search(q, k)
        i = i.copy()
        i[0, 0] = i[0, -1] + 1 if i[0, -1] + 1 not in i[0] else i[0, -1] + 2
        return d, i


class Repeated(PortSystem):
    """One answer with a row id twice (at the distance the first copy has),
    as the graph search returned for one query of one seed on the card."""

    @staticmethod
    def repeat(d, i):
        d, i = d.copy(), i.copy()
        if i.shape[1] > 2:
            d[0, 2], i[0, 2] = d[0, 1], i[0, 1]
        return d, i

    def search(self, q, k, ef):
        return self.repeat(*super().search(q, k, ef))

    def scan_search(self, q, k):
        return self.repeat(*super().scan_search(q, k))


class InsertUnchanged(PortSystem):
    """An insert that returns the index as it was."""

    def insert(self, rows, ids):
        pass


class DeleteUnchanged(PortSystem):
    """A delete that returns the index as it was."""

    def delete(self, ids):
        pass


class QuarterSkipped(BlockSkipped):
    """The reads over all live rows but a quarter of the slots: at the
    tiny sizes the graph finds every nearest row even at half its ef, so
    the graph cells' fault leaves out more."""

    share = 0.25


def factory(cls):
    return lambda config, device: cls(config["index"], config["corpus"]["dims"], device)


@pytest.mark.parametrize("name", ["gist1m.graph-k10", "sift1m.scan-k100", "sift1m.churn"])
def test_a_sound_run_is_correct(root, name):
    r = run(root, name)
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert 0.9 <= r["metrics"]["recall"]["value"] <= 1.0
    assert list(r)[-1] == "check"


@pytest.mark.parametrize("name", ["gist1m.graph-k10", "sift1m.scan-k100", "sift1m.churn"])
def test_the_control_is_not_correct(root, name):
    r = run(root, name, make_system=ControlSystem)
    n = numbers(r)
    assert not r["correct"]
    assert n["dist_err"] > 10 * r["check"]["dist_err"]["limit"]
    assert n["bad_answers"] == 0


@pytest.mark.parametrize("name", ["gist1m.graph-k10", "sift1m.scan-k100", "sift1m.churn"])
@pytest.mark.parametrize("fault", [HalfBatch, Altered], ids=["half-batch", "altered"])
def test_a_read_fault_is_not_correct(root, name, fault):
    r = run(root, name, make_system=factory(fault))
    assert not r["correct"]
    assert numbers(r)["dist_err"] > r["check"]["dist_err"]["limit"]


@pytest.mark.parametrize("name", ["gist1m.graph-k10", "sift1m.scan-k100", "sift1m.churn"])
def test_an_id_repeated_in_an_answer_is_not_correct(root, name):
    r = run(root, name, make_system=factory(Repeated))
    assert not r["correct"]
    assert numbers(r)["bad_answers"] > 0


@pytest.mark.parametrize("name,fault", [("sift1m.scan-k100", BlockSkipped),
                                        ("gist1m.graph-k10", QuarterSkipped),
                                        ("sift1m.churn", QuarterSkipped)])
def test_answers_true_row_by_row_but_not_the_nearest_are_not_correct(root, name, fault):
    r = run(root, name, make_system=factory(fault))
    n = numbers(r)
    assert not r["correct"]
    assert n["knn_missed"] > r["check"]["knn_missed"]["limit"]
    # every distance is that of its row: only knn_missed sees it
    assert n["dist_err"] <= r["check"]["dist_err"]["limit"] and n["bad_answers"] == 0


@pytest.mark.parametrize("name", ["gist1m.graph-k10", "sift1m.churn"])
def test_the_graph_cells_fault_of_the_card_runs_here(root, name):
    # half the ef, the fault read on the card for the graph cells; the tiny
    # graph still finds every nearest row with it, hence the quarter above
    r = run(root, name, make_system=SYSTEMS["ef-halved"])
    assert r["failed"] == 0 and 0.0 <= numbers(r)["knn_missed"] <= 1.0


def test_an_insert_that_leaves_the_state_unchanged_is_not_correct(root):
    r = run(root, "sift1m.churn", make_system=factory(InsertUnchanged))
    assert not r["correct"]
    assert numbers(r)["inserts_missed"] == 1.0


def test_a_delete_that_leaves_the_state_unchanged_is_not_correct(root):
    r = run(root, "sift1m.churn", make_system=factory(DeleteUnchanged))
    assert not r["correct"]
    assert numbers(r)["bad_answers"] > 0
