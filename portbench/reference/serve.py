"""The plain reference of a served cell: the serve loop's steps worked out
again from the requests, then each step computed by a plain model.

``schedule`` follows the rules of the port's continuous-batching loop
(``ServeLoop``) from the requests in the order they were submitted and
the tokens the program served: at the start of every step each empty
slot, in slot order, takes the next queued request and teacher-forces its
prompt but the last token, one full-batch step at each position 0..P-2
with that slot's token and every other slot's last token; then one
decode step of the whole batch at the maximum position over the active
slots.  Each active slot takes its served token; a request ends at its
output length or when its position reaches ``max_seq`` - 1, and the
closed loop submits the next request for each one that ended.

``judge`` runs those steps through the plain model (float32, or float8
products for the control) and reads, at every decode step and for every
active slot, how far the served token's logit lies below the
reference's best: the widest such gap is the number ``correct``
compares.  Each gap is taken in units of the standard deviation of the
reference's logits at that position, so that one limit reads alike on a
model's published widths and on a small copy of it.  With ``control``
the same steps run a second time in the lower precision, and the reading
is the gap of the token that precision puts first.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from portbench.reference.common import Arith, exact_f32


@dataclass
class Step:
    tokens: list                 # one token a slot
    pos: int
    compare: list = field(default_factory=list)   # (slot, served token)


def schedule(requests: list, slots: int, max_seq: int, clients: int,
             decode_steps: int) -> tuple[list, str]:
    """The steps of ``decode_steps`` loop steps over ``requests`` (each
    ``(prompt, max_new, served)`` in submission order).  Returns (steps,
    fault): ``fault`` is empty, or says where the served tokens do not fit
    the loop's rules (a token missing, or more served than the rules
    allow)."""
    queue = list(range(min(clients, len(requests))))
    nxt = len(queue)
    active = [None] * slots
    pos = [0] * slots
    toks = [0] * slots
    taken = [0] * len(requests)
    steps: list[Step] = []
    for _ in range(decode_steps):
        for i in range(slots):
            if active[i] is None and queue:
                r = queue.pop(0)
                active[i] = r
                prompt = [int(t) for t in requests[r][0]]
                for t, tok in enumerate(prompt[:-1]):
                    row = list(toks)
                    row[i] = tok
                    steps.append(Step(row, t))
                pos[i] = len(prompt) - 1
                toks[i] = prompt[-1]
        live = [i for i in range(slots) if active[i] is not None]
        if not live:
            return steps, "a step with no active slot in a closed loop"
        st = Step(list(toks), max(pos[i] for i in live))
        for i in live:
            r = active[i]
            served = requests[r][2]
            if taken[r] >= len(served):
                return steps, (f"request {r}: the loop's rules give it token "
                               f"{taken[r] + 1}, the program served "
                               f"{len(served)}")
            tok = int(served[taken[r]])
            st.compare.append((i, tok))
            taken[r] += 1
            pos[i] += 1
            toks[i] = tok
            if taken[r] >= requests[r][1] or pos[i] >= max_seq - 1:
                active[i] = None
                if nxt < len(requests):
                    queue.append(nxt)
                    nxt += 1
        steps.append(st)
    for r, (_, _, served) in enumerate(requests):
        if taken[r] != len(served):
            return steps, (f"request {r}: served {len(served)} tokens, the "
                           f"loop's rules give it {taken[r]}")
    return steps, ""


def _gaps(logits, pick):
    """How far each picked token's logit lies below its row's best, in
    standard deviations of the row."""
    return (logits.max(-1).values - logits.gather(1, pick[:, None])[:, 0]) \
        / logits.std(-1)


def judge(model, params: dict, cfg: dict, steps: list, slots: int,
          max_seq: int, device, control: bool = False) -> dict:
    """{"widest_gap", "compared"} of the served tokens against ``model``
    (``portbench.reference.<name>``) over ``steps``; with ``control`` the
    gap of the float8 control's own first token instead.  A model whose
    step reads no position (``stream``) runs every step at once; one
    with positions (``chunk``) each run of steps at consecutive
    positions."""
    if not steps:
        return {"widest_gap": float("nan"), "compared": 0}
    compared = sum(len(s.compare) for s in steps)
    with exact_f32():
        ref_ar, low_ar = Arith(False), Arith(True, frozen=True)
        # every step's inputs and served tokens go to the device at once
        toks = torch.tensor([s.tokens for s in steps], dtype=torch.long,
                            device=device)
        served = [[0] * slots for _ in steps]
        mask = [[False] * slots for _ in steps]
        for j, s in enumerate(steps):
            for i, t in s.compare:
                served[j][i], mask[j][i] = t, True
        served = torch.tensor(served, dtype=torch.long, device=device)
        mask = torch.tensor(mask, device=device)
        if hasattr(model, "stream"):
            rows = mask.nonzero().T.flip(0)              # (slot, step)
            logits = model.stream(params, cfg, ref_ar, toks.T, rows)
            pick = model.stream(params, cfg, low_ar, toks.T, rows).argmax(-1) \
                if control else served.T[rows[0], rows[1]]
            return {"widest_gap": float(_gaps(logits, pick).max()),
                    "compared": compared}
        # runs of steps at consecutive positions go at once
        state = model.init_state(cfg, slots, max_seq, device)
        low = model.init_state(cfg, slots, max_seq, device) if control \
            else None
        widest = torch.zeros((), device=device)
        cuts = [0] + [j for j in range(1, len(steps))
                      if steps[j].pos != steps[j - 1].pos + 1] + [len(steps)]
        for a, z in zip(cuts, cuts[1:]):
            x = toks[a:z].T
            h = model.chunk(params, cfg, ref_ar, x, steps[a].pos, state)
            hl = model.chunk(params, cfg, low_ar, x, steps[a].pos, low) \
                if control else None
            t, i = mask[a:z].nonzero().T
            if not len(t):
                continue
            logits = model.head(params, cfg, ref_ar, h[i, t])
            pick = model.head(params, cfg, low_ar, hl[i, t]).argmax(-1) \
                if control else served[a:z][t, i]
            widest = torch.maximum(widest, _gaps(logits, pick).max())
        return {"widest_gap": float(widest), "compared": compared}
