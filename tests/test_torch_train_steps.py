"""Several train steps of the port against JAX's on the CPU: rwkv6's loss
over four steps.

On the H100, rwkv6-7b's loss rose over its four steps (full width, four
layers, bf16, lr 3e-4 with no warmup, two microbatches). The same run at
smoke size, float32, from JAX's own parameters bridged to the port and
the same ``SyntheticLM`` batches: ``make_train_step`` of either package
(its default lr 3e-4, no schedule; ``grad_accum`` 2 as on the card) four
times. JAX runs op by op, as the train tests run it. Each loss is held to
JAX's within the train tests' ``TOL`` relative, so the loss curve,
rising or falling, is the model's and the optimizer's, not the port's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.data import SyntheticLM as JaxSyntheticLM
from repro.launch import steps as jsteps
from repro.optim import adamw_init as jadamw_init
from repro_torch.data import SyntheticLM
from repro_torch.launch import steps as tsteps
from repro_torch.optim import adamw_init
from test_torch_train import TOL, _bridged

STEPS = 4


def test_rwkv6_four_step_losses_match_jax():
    jcfg, tcfg, jp, tp = _bridged("rwkv6_7b", grad_accum=2)
    jdata = JaxSyntheticLM(jcfg.vocab, 32, 4, seed=0)
    tdata = SyntheticLM(tcfg.vocab, 32, 4, seed=0)
    jstep, tstep = jsteps.make_train_step(jcfg), tsteps.make_train_step(tcfg)
    jopt, topt = jadamw_init(jp), adamw_init(tp)
    jlosses, tlosses = [], []
    for _, jb, tb in zip(range(STEPS), jdata, tdata):
        for k in jb:
            np.testing.assert_array_equal(jb[k], tb[k])
        jloss, jp, jopt = jstep(jp, jopt, {k: jnp.asarray(v)
                                           for k, v in jb.items()})
        tloss, tp, topt = tstep(tp, topt, {k: torch.from_numpy(v)
                                           for k, v in tb.items()})
        jlosses.append(float(jloss))
        tlosses.append(float(tloss))
    assert int(topt.step) == int(jopt.step) == STEPS
    for i, (got, want) in enumerate(zip(tlosses, jlosses), 1):
        assert abs(got - want) <= TOL * abs(want), \
            f"step {i}: port {tlosses}, JAX {jlosses}"
    assert all(np.isfinite(tlosses)) and len(set(tlosses)) == STEPS
