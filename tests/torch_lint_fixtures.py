"""Known-bad / known-good twins of the port's torch hazard rules that also
run on the card.

The port's raylint tests lint them here on the CPU; phase 4m of
`chip_smoke.py` lints them on the H100 machine and then runs them: each
bad twin of RL020 and RL021 must hit a synchronizing CUDA operation under
`torch.cuda.set_sync_debug_mode("error")`, and each good twin must run
through; the bad twin of RL024 forks a child that cannot use the card,
and its good twin spawns one that can. Each twin is the text of a module
(written to a file to be linted and imported), with its entry point named
in `ENTRY`.
"""

RL020_BAD = """
    import torch


    def train_step(x: torch.Tensor):
        if x.sum() > 0:
            return x * 2
        return x
"""

RL020_GOOD = """
    import torch


    def train_step(x: torch.Tensor):
        return torch.where(x.sum() > 0, x * 2, x)
"""

RL021_BAD = """
    import torch


    def decode_step(logits: torch.Tensor, slots):
        nxt = logits.argmax(-1)
        out = []
        for s in slots:
            out.append(int(nxt[s]))
        return out
"""

# The one sync before the loop is an event wait after a non-blocking copy
# into pinned memory: the host copy RL021 prescribes, made without a
# synchronizing copy.
RL021_GOOD = """
    import torch


    def decode_step(logits: torch.Tensor, slots):
        nxt = logits.argmax(-1)
        host = torch.empty(nxt.shape, dtype=nxt.dtype, pin_memory=True)
        host.copy_(nxt, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        out = []
        for s in slots:
            out.append(int(host[s]))
        return out
"""

_RL024 = """
    import multiprocessing

    import torch


    def child(q):
        try:
            q.put(("ok", float(torch.ones(2, device="cuda").sum())))
        except RuntimeError as e:
            q.put(("error", str(e)))


    def launch():
        torch.zeros(1, device="cuda")
        ctx = multiprocessing.get_context("{method}")
        q = ctx.Queue()
        p = ctx.Process(target=child, args=(q,))
        p.start()
        got = q.get(timeout=120)
        p.join(timeout=60)
        return got
"""

RL024_BAD = _RL024.replace("{method}", "fork")
RL024_GOOD = _RL024.replace("{method}", "spawn")

#: twin -> (rule it is about, entry point)
ENTRY = {
    "RL020_BAD": ("RL020", "train_step"),
    "RL020_GOOD": ("RL020", "train_step"),
    "RL021_BAD": ("RL021", "decode_step"),
    "RL021_GOOD": ("RL021", "decode_step"),
    "RL024_BAD": ("RL024", "launch"),
    "RL024_GOOD": ("RL024", "launch"),
}
