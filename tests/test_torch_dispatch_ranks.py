"""The Coach's multi-step dispatch on two gloo ranks on the CPU (tiny
widths, 64 px; ``tests/torch_parallel_worker.py``): the stack agreed over
the ranks once a dispatch and the all-reduces inside the static step give
the steps the ranks take one a call, bit for bit (on the card the same
dispatch replays a captured graph with NCCL's all-reduces inside:
``chip_smoke.py --only parallel`` on two cards or more)."""

import torch

import torch_parallel_worker as W
from test_torch_parallel import _coach_spec


def test_two_ranks_dispatch_as_they_step_one_at_a_time(tmp_path):
    """Coach.train() on two ranks for 4 steps (two epochs of the 6-item
    set, a full save and a metric line every 2 steps), one step a call and
    then 2 a dispatch in the same process group: the dispatch ranks
    bit-identical to each other and to the one-step ranks (trainable leaves
    and heads), and their logged losses the same."""
    specs = []
    for spd in (1, 2):
        spec = _coach_spec([tmp_path / f"spd{spd}" / f"rank{r}" for r in range(2)])
        spec["cfg"].compute.steps_per_dispatch = spd
        spec["cfg"].steps.max_steps = 4
        spec["cfg"].steps.save_interval = spec["cfg"].steps.metric_interval = 2
        specs.append(spec)
    ranks = W.run_ranks(W.coach_ranks_each, 2, tmp_path, specs, timeout=180)
    eager = ranks[0][0]
    for r, (one, disp) in enumerate(ranks):
        for part in ("leaves", "heads"):
            assert list(disp[part]) == list(eager[part])
            for name, t in eager[part].items():
                assert torch.equal(disp[part][name], t), (r, part, name)
        strip = [[{k: v for k, v in m.items() if k != "steps_per_sec"} for _, m in rec["logged"]]
                 for rec in (one, disp)]
        assert strip[0] == strip[1] and len(strip[1]) == 2 + 1  # train at 2 and 4, val
