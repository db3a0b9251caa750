"""Each cell's inputs, byte for byte: at the tiny size and one seed, the
SHA-256 of every container and of every stream's source frames, as the
harness made them before it took palettized codecs and audio tracks.  A
configuration with neither has to get the same bytes, so no cell's inputs
move under a change to the input makers."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

from portbench.spec import CHECKOUT, Bench

SEED = 2**31 + 99
# cell -> (pool stream of each slot, digest of pool stream p's container,
# of its source frames [T, Y, X] u32)
FROZEN = {
    "sp1080_terminal_kmv_elided": (
        [1, 0, 2, 3],
        ["5adf17cbfbd3d412eb3638440c7b30ae29572252cd78794384a948e3fbe9394b",
         "005daf752de448876421116d6d7b4ce881b73571843a0a5b6b51b9679a12f3c4",
         "91e8d128430ac45cbbfc36999158809ef776b64ad1078c73e1371a385fac1015",
         "588d993711db40807ea1272c6c6f6bc8abe5e0d77f9d7471b0c9b8808a26e8c3"],
        ["87774b38e95a12f86362c0d82963d4a4f77adaca2eec1e2a2f271364b9ab56ee",
         "04e1c11fc3014691c910eb29bfad7a2b795398b085d61eb58885f552cf2a5253",
         "a6bb71295defcde401a354801b140d5874e89c70bcb9a02683f23a9825b8f083",
         "b22cd85cf18302e4d35758fa1689d917b2d4052614e71e939e605f7fb9d070db"]),
    "msv1_qvga16_desktop": (
        [0, 1, 2, 0, 3, 1, 2, 3],
        ["8f68d43d0b261fd45ba8b35b73f79189c9ad438c524811f40d30ca50e76ba202",
         "0d10e03e8c5cde85ea18a7638c608c1b2146b8b414d5327420c0ba24b59de7e8",
         "de2cf0377eb23fba23280079c1d2b568204406448c4a650d3a7c5369174f272b",
         "dee81439d40c9171c056a725ec90afe366825b194f0387a73de9490db464e3e0"],
        ["ed52e6cb41b478e0a96ba2feb228522a91c3a0a7c64ef3f4b80cd8e734f2c951",
         "914480f62e75743f9c4a94ff6c1c161962b77fe1a4e966191b54c580aae868d4",
         "d590d83d1cf157282b4674f571f0a2da14c2ea6a68fec6ea7c09811d159f318b",
         "2891d30de7d0c035363fdb463425a42e2676ae7c0ba7130890453b6f27131985"]),
    "sp1080_terminal_lane_rans": (
        [1, 0, 2, 3],
        ["fddcbf289a07d2792801d2789992d6db284a3ace8ab65ae9732d4f2e92911e47",
         "5aced199b77bd6cc831cbe99a62b5e478b61ccff5bea8ada555d5f98caf498e7",
         "2bcd7f375dd7e7e308388a5f25c640bb1cfc364808e7eef8e27375995b8be96f",
         "15c88d5c22936f1b85c14f683f557d3dbc80ba285e97e24330ecab4dd9c0b103"],
        ["87774b38e95a12f86362c0d82963d4a4f77adaca2eec1e2a2f271364b9ab56ee",
         "04e1c11fc3014691c910eb29bfad7a2b795398b085d61eb58885f552cf2a5253",
         "a6bb71295defcde401a354801b140d5874e89c70bcb9a02683f23a9825b8f083",
         "b22cd85cf18302e4d35758fa1689d917b2d4052614e71e939e605f7fb9d070db"]),
    "sp1080_terminal_kmv_elided_dp4": (
        [0, 2, 0, 1, 1, 0, 2, 3, 1, 2, 0, 3, 1, 2, 3, 3],
        ["5adf17cbfbd3d412eb3638440c7b30ae29572252cd78794384a948e3fbe9394b",
         "005daf752de448876421116d6d7b4ce881b73571843a0a5b6b51b9679a12f3c4",
         "91e8d128430ac45cbbfc36999158809ef776b64ad1078c73e1371a385fac1015",
         "588d993711db40807ea1272c6c6f6bc8abe5e0d77f9d7471b0c9b8808a26e8c3"],
        ["87774b38e95a12f86362c0d82963d4a4f77adaca2eec1e2a2f271364b9ab56ee",
         "04e1c11fc3014691c910eb29bfad7a2b795398b085d61eb58885f552cf2a5253",
         "a6bb71295defcde401a354801b140d5874e89c70bcb9a02683f23a9825b8f083",
         "b22cd85cf18302e4d35758fa1689d917b2d4052614e71e939e605f7fb9d070db"]),
}


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


@pytest.mark.parametrize("workload", sorted(FROZEN))
def test_inputs_are_frozen(tiny_checkout, workload):
    from portbench.inputs import make_inputs

    assert workload in [w["name"] for w in Bench(CHECKOUT).spec["workloads"]]
    cell = Bench(tiny_checkout).cell(workload)
    inp = make_inputs(cell, SEED)
    pool, containers, frames = FROZEN[workload]
    assert inp.pool == pool
    assert [_sha(c) for c in inp.containers] == [containers[p] for p in pool]
    assert all(f.dtype == np.uint32 for f in inp.frames)
    assert [_sha(np.ascontiguousarray(f).tobytes()) for f in inp.frames] == \
        [frames[p] for p in pool]
    assert inp.audio == [None] * len(pool)
