"""Two processes, one chain mesh: the port's twin of
``tests/test_parallel.py::test_multihost_two_process_end_to_end``
(``tests/multihost_worker.py``). Each process starts the group with
``parallel.multihost.initialize`` (gloo, a rendezvous file), builds only
its own chains' rows with ``host_local_state`` (equal to a one-process
call's), runs a sharded MH chain whose rows equal the unsharded replay's,
reduces the tracker's R-hat across processes, and saves a sharded
checkpoint from both (rank 0 writes) that restores bit for bit, with
``restore_sampler(mesh=)`` continuing the chains. The rank side is
``torch_multihost_cases.py``.
"""

import pytest
import torch

import torch_dist
import torch_multihost_cases as cases

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_dist.run_ranks(cases.run, 2,
                                tmp_path_factory.mktemp("multihost"),
                                timeout=120, start_group=False)


def test_initialize_and_global_mesh(ranks):
    for rank, res in enumerate(ranks):
        assert res["world"] == 2 and res["rank"] == rank
        assert res["mesh_size"] == 2


def test_host_local_state_matches_one_process(ranks):
    for res in ranks:
        assert res["local_rows"] == cases.N_CHAINS // 2
        assert res["init_equal"]


def test_sharded_run_matches_unsharded_replay(ranks):
    for res in ranks:
        assert res["run_equal"] and res["sampler_equal"]


def test_tracker_max_rhat_across_processes(ranks):
    for res in ranks:
        got, want = res["max_rhat"]
        assert got == pytest.approx(want, rel=1e-5) and got > 0


def test_sharded_checkpoint_round_trip(ranks):
    for res in ranks:
        assert res["restored_equal"] and res["restore_continues"]
        c = res["save_counts"]
        assert c["all_gather"] >= 1 and c["barrier"] == 1
