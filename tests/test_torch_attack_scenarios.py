"""The attack-scenario gates of ``tests/test_attack_scenarios.py`` on the
port's flat and tiered rounds (``repro_torch.api.build_runtime``, on the
CPU), with the reference's configs and gates.

* For every attack in the port's ``core.attacks.ATTACKS`` at 30 %
  malicious participation, from a warm-started model, the committee keeps
  malicious updates out of the packed set (below the attack's gate and
  below the rate of the committee-free ``accept_all`` baseline), while
  ``accept_all`` packs them at about the participation rate.
* In a tiered round (S = 2) whose slice 0 is wholly compromised, trainers
  and sub-committee colluding, the poisoned sub-aggregate passes its own
  tier-1 vote and is caught at tier 2.

The warm start is the reference's: its ``train_standalone`` (150 steps)
carried across through numpy, so both packages' rounds start from one
model, the model the gates were pinned on.  (From the port's own warm
start, which differs from the reference's in its last bits, the
``scaled`` attack packed 8 of 32 slots, 0.25, on the gate itself.)
"""
import pytest

from repro_torch.api import build_runtime
from repro_torch.convert import from_numpy_tree
from repro_torch.core.attacks import ATTACKS, poison_membership
from repro_torch.data import make_femnist_like
from repro_torch.fl import femnist_adapter
from repro_torch.fl.hier import sample_tiered

MALICIOUS_FRACTION = 0.3
ROUNDS = 6
K = 8

CFG = dict(active_proportion=0.7, committee_fraction=0.4, k_updates=K,
           local_steps=20, local_batch=32, local_lr=0.05, collusion=False,
           malicious_fraction=MALICIOUS_FRACTION, attack_sigma=2.0, seed=1)
# the reference's per-attack packed-malicious gates (one-slot-granular
# pins over 4 rounds x k = 8 packed slots)
GATES = {"gaussian": 0.2, "sign_flip": 0.2, "scaled": 0.25}

HIER_TIERS = 2
HIER_ROUNDS = 5
HIER_CFG = dict(active_proportion=1.0, committee_fraction=1 / 6,
                k_updates=4, local_steps=20, local_batch=32, local_lr=0.05,
                collusion=True, malicious_fraction=0.0, attack="gaussian",
                attack_sigma=6.0, seed=1)


@pytest.fixture(scope="module")
def ds():
    return make_femnist_like(num_clients=24, mean_samples=60,
                             test_size=300, seed=3)


@pytest.fixture(scope="module")
def adapter():
    return femnist_adapter(width=8)


@pytest.fixture(scope="module")
def warm_params():
    import jax
    import numpy as np

    from repro.data import make_femnist_like as j_make_femnist_like
    from repro.fl import femnist_adapter as j_femnist_adapter
    from repro.fl.baselines import train_standalone as j_train_standalone

    warm, _ = j_train_standalone(
        j_femnist_adapter(width=8),
        j_make_femnist_like(num_clients=24, mean_samples=60, test_size=300,
                            seed=3),
        steps=150, batch=32, lr=0.05, eval_every=1000)
    return from_numpy_tree(jax.tree.map(np.asarray, warm))


def _bflc_packed_malicious_rate(ds, adapter, warm, attack: str) -> float:
    rt = build_runtime(adapter, ds, dict(CFG, attack=attack),
                       initial_params=warm, device="cpu")
    logs = rt.run(ROUNDS, eval_every=ROUNDS + 1)
    assert rt.chain.verify()
    later = logs[2:]        # the first elected committees still settle
    return sum(l.packed_malicious for l in later) / (K * len(later))


def _accept_all_packed_malicious_rate(ds, adapter, warm, attack: str) -> float:
    packed = []
    bl = build_runtime(
        adapter, ds,
        dict(active_proportion=0.7, local_steps=20, local_batch=32,
             local_lr=0.05, malicious_fraction=MALICIOUS_FRACTION,
             attack=attack, attack_sigma=2.0, seed=1),
        baseline=True, initial_params=warm, device="cpu",
        # the baseline's rewarder slot is a no-op: hook it to see what the
        # accept_all validator and pack_all packer let through
        stages={"rewarder": lambda ctx: packed.append(list(ctx.packed_ids))},
    )
    bl.run(ROUNDS, eval_every=ROUNDS + 1)
    mal = bl.malicious
    return (sum(sum(1 for u in r if u in mal) for r in packed)
            / sum(len(r) for r in packed))


@pytest.mark.slow
@pytest.mark.parametrize("attack", sorted(ATTACKS))
def test_committee_filters_attack_but_accept_all_does_not(
        ds, adapter, warm_params, attack):
    bflc_rate = _bflc_packed_malicious_rate(ds, adapter, warm_params, attack)
    accept_rate = _accept_all_packed_malicious_rate(ds, adapter, warm_params,
                                                    attack)
    assert accept_rate > 0.2, (attack, accept_rate)
    assert bflc_rate < GATES[attack], (attack, bflc_rate)
    assert bflc_rate < accept_rate, (attack, bflc_rate, accept_rate)


@pytest.mark.slow
def test_colluding_sub_committee_caught_at_tier2(ds, adapter, warm_params):
    def colluding_sampler(ctx):
        sample_tiered(ctx)
        if ctx.cohort == 0:
            sl = ctx.hier.slices[0]
            poison_membership(ctx.manager,
                              list(sl.trainers) + list(sl.committee))

    rt = build_runtime(adapter, ds, dict(HIER_CFG), tiers=HIER_TIERS,
                       initial_params=warm_params, device="cpu",
                       stages={"sampler": colluding_sampler})
    logs = rt.run(HIER_ROUNDS, eval_every=HIER_ROUNDS + 1)
    assert rt.chain.verify()
    # the compromised slice's representative is malicious and passed its
    # colluding tier-1 vote: tier 2 was shown a poisoned sub-aggregate
    mal = {i for i, nd in rt.manager.nodes.items() if nd.is_malicious}
    assert mal, "poison_membership never ran"
    last = rt.chain.committee_at_round(HIER_ROUNDS - 1)
    assert any(int(u) in mal for u in last["uploaders"])
    later = logs[1:]
    hier_rate = sum(l.packed_malicious for l in later) / (HIER_TIERS * len(later))
    # without tier 2 the poisoned sub-aggregate is packed every round: 1/S
    no_tier2_rate = 1.0 / HIER_TIERS
    assert hier_rate < no_tier2_rate / 2, (hier_rate, no_tier2_rate)
    assert hier_rate <= 0.2, hier_rate
    # the tier-2 audit block marks the compromised sub-aggregate rejected
    rejected_rounds = sum(
        1 for t in range(1, HIER_ROUNDS)
        if not all(rt.chain.committee_at_round(t)["accepted"]))
    assert rejected_rounds >= (HIER_ROUNDS - 1) // 2, rejected_rounds
