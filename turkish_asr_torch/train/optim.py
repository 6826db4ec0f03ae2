"""Optimizer and learning-rate schedule.

Counterpart of turkish_asr_tpu/train/optim.py, which chains optax's
``clip_by_global_norm`` -> ``adamw`` (scale_by_adam, add_decayed_weights,
scale_by_learning_rate) under ``MultiSteps`` for accumulation. The update
rules are written out here with optax's formulas and fp32 arithmetic:

- OneCycle with torch's exact step indexing (``torch_onecycle_schedule``,
  :22-49), evaluated in fp32 like the JAX schedule;
- clipping by global norm as optax does it: g stays when ||g|| < c, else
  (g / ||g||) * c. This is not ``torch.nn.utils.clip_grad_norm_``, which
  divides by ||g|| + 1e-6;
- AdamW with bias correction, decoupled weight decay on every parameter,
  and the learning rate of the update count before the update;
- ``MultiSteps``: the running mean of k micro-gradients
  (acc + (g - acc) / (n + 1)), one inner update (and one schedule step)
  per k, and a flush that feeds zero micro-gradients to the window's end.

Updates are in place under ``torch.no_grad``. On a mesh whose "model" axis
shards parameters, the global norm is that of the full gradient
(``ClippedAdamW.sq_norm``), so every rank clips by the same factor.
"""

import math

import torch


def sq_norm_of(grads):
    """The squared global norm of ``grads`` (fp32)."""
    return sum(torch.sum(g.float() ** 2) for g in grads)


def torch_onecycle_schedule(peak_value, total_steps, pct_start=0.1, div_factor=25.0,
                            final_div_factor=1e4):
    """OneCycleLR with torch's exact indexing: phase ends at
    ``pct_start * total_steps - 1`` (at least 1) and ``total_steps - 1``;
    cosine anneal ``end + (start - end) / 2 * (1 + cos(pi * pct))`` with pct
    clipped to [0, 1]. Returns count -> fp32 learning rate (a float)."""
    init = peak_value / div_factor
    final = init / final_div_factor
    end1 = max(float(pct_start * total_steps) - 1.0, 1.0)
    end2 = max(float(total_steps - 1), end1 + 1.0)

    def schedule(count):
        s = torch.tensor(float(count), dtype=torch.float32)
        pct1 = torch.clamp(s / end1, 0.0, 1.0)
        lr1 = peak_value + (init - peak_value) / 2.0 * (1.0 + torch.cos(math.pi * pct1))
        pct2 = torch.clamp((s - end1) / (end2 - end1), 0.0, 1.0)
        lr2 = final + (peak_value - final) / 2.0 * (1.0 + torch.cos(math.pi * pct2))
        return float(torch.where(s <= end1, lr1, lr2))

    return schedule


class ClippedAdamW:
    """clip_by_global_norm(clip) -> adamw(schedule, b1, b2, eps, weight_decay).
    ``sq_norm``: gradients -> their squared global norm (the trainer sets
    a mesh's, ``parallel/mesh.grad_sq_norm``)."""

    def __init__(self, params, schedule, weight_decay, gradient_clip=1.0, b1=0.9, b2=0.999,
                 eps=1e-8):
        self.params = list(params)
        self.sq_norm = sq_norm_of
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.gradient_clip = gradient_clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def update(self, grads):
        """One update of every parameter from ``grads`` (one per param)."""
        norm = torch.sqrt(self.sq_norm(grads))
        clip = self.gradient_clip
        grads = [torch.where(norm < clip, g, (g / norm) * clip) for g in grads]
        count_inc = self.count + 1
        f32 = dict(dtype=torch.float32, device=self.params[0].device)
        bc1 = 1 - torch.tensor(self.b1, **f32) ** count_inc
        bc2 = 1 - torch.tensor(self.b2, **f32) ** count_inc
        lr = self.schedule(self.count)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * g ** 2 + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.weight_decay * p
            p.add_(-lr * u)
        self.count = count_inc

    @property
    def step_count(self):
        return self.count

    def state_dict(self):
        return {"count": self.count, "mu": [m.clone() for m in self.mu],
                "nu": [n.clone() for n in self.nu]}

    def load_state_dict(self, state):
        if len(state["mu"]) != len(self.mu):
            raise ValueError(f"optimizer state has {len(state['mu'])} moments, "
                             f"the model {len(self.mu)} parameters")
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            if dst.shape != src.shape:
                raise ValueError(f"optimizer moment shape {tuple(src.shape)} != "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)


class MultiSteps:
    """optax.MultiSteps(inner, every_k_schedule=k) with the gradient mean."""

    def __init__(self, inner, k):
        self.inner = inner
        self.k = k
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in inner.params]

    @torch.no_grad()
    def update(self, grads):
        n = self.mini_step
        for a, g in zip(self.acc, grads):
            a.add_((g - a) / (n + 1))
        if n == self.k - 1:
            self.inner.update(self.acc)
            for a in self.acc:
                a.zero_()
        self.mini_step = (n + 1) % self.k

    def flush(self):
        """Feed zero micro-gradients to the window's end, so a partial
        window applies sum(collected) / k (JAX ``flush_accumulation``).
        Returns whether an update was applied."""
        if self.mini_step == 0:
            return False
        zeros = [torch.zeros_like(a) for a in self.acc]
        while self.mini_step:
            self.update(zeros)
        return True

    @property
    def step_count(self):
        return self.inner.count

    @property
    def sq_norm(self):
        return self.inner.sq_norm

    def state_dict(self):
        return {"inner": self.inner.state_dict(), "mini_step": self.mini_step,
                "acc": [a.clone() for a in self.acc]}

    def load_state_dict(self, state):
        self.inner.load_state_dict(state["inner"])
        self.mini_step = int(state["mini_step"])
        for dst, src in zip(self.acc, state["acc"]):
            dst.copy_(src)


def make_optimizer(params, learning_rate, weight_decay, total_steps, pct_start=0.1,
                   gradient_clip=1.0, accumulation_steps=1):
    """(optimizer, schedule), as the JAX ``make_optimizer``: at least 10
    schedule steps so the warmup is never empty; ``MultiSteps`` when
    accumulating."""
    schedule = torch_onecycle_schedule(learning_rate, max(int(total_steps), 10),
                                       pct_start=pct_start)
    opt = ClippedAdamW(params, schedule, weight_decay, gradient_clip)
    if accumulation_steps > 1:
        opt = MultiSteps(opt, accumulation_steps)
    return opt, schedule
