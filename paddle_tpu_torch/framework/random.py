"""The random state (port of the reference's ``framework/random.py``).

The reference splits JAX PRNG keys from one global generator that
``paddle.seed`` seeds, and hands traced code explicit keys.  The port runs
eagerly on torch's generators, one a device:

- :class:`Generator` holds one ``torch.Generator`` a device (made at first
  use, seeded with the generator's seed); ``split`` and ``next_key`` fork
  new streams from it;
- :data:`default_generator` is torch's own global generators
  (``torch.default_generator`` on the CPU, each card's default CUDA
  generator), which a draw given no generator takes; :func:`seed` seeds
  them all (``torch.manual_seed``), offset by the process rank when
  ``seed_offset_by_rank`` is on; :func:`get_rng_state` /
  :func:`set_rng_state` read and restore every device's state;
- :class:`key_scope` makes the draws inside it (``tensor.random``,
  ``gumbel_softmax``) take the scope's generator, as the reference's traced
  draws take the scope's key; :func:`next_key` returns a ``torch.Generator``
  forked from the scope's generator (or the given one, or the default);
- :func:`bulk_key` returns its key: the reference swaps in the TPU's
  ``rbg`` generator for dropout masks, and torch's CUDA generator is
  already counter-based (Philox), so there is nothing to swap;
- :func:`_keep_mask` and :func:`_uniform` are the one seam every dropout
  mask and RReLU slope of the port is drawn through.  They draw from the
  generator :func:`generator_for` resolves (the caller's, the scope's, or
  the device's global one) without forking it: a fork reads a seed back to
  the host, a device-to-host sync on the card, where drawing from the
  generator itself only advances its Philox offset on the host.

JAX's and torch's bits differ, so a seed fixes the port's draws, not the
reference's: tests hold the laws, and weights cross between the packages
through ``convert.py`` (ROADMAP §C).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Union

import torch

from ..device import resolve_device
from .flags import get_flags

__all__ = ["seed", "Generator", "default_generator", "next_key", "get_rng_state",
           "set_rng_state", "key_scope", "bulk_key"]

_DEFAULT_SEED = 0
_SEED_BOUND = 1 << 62


def _dev(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _fork(gen: torch.Generator, device: torch.device) -> torch.Generator:
    """A new generator on ``device`` seeded by one draw of ``gen``."""
    s = int(torch.randint(_SEED_BOUND, (1,), generator=gen, device=gen.device).item())
    return torch.Generator(device).manual_seed(s)


class Generator:
    """A seeded random stream on every device: one ``torch.Generator`` a
    device, each seeded with this generator's seed.  Thread-safe."""

    def __init__(self, seed: int = _DEFAULT_SEED):
        self._lock = threading.Lock()
        self._gens: Dict[torch.device, torch.Generator] = {}
        self.manual_seed(seed)

    def manual_seed(self, seed: int) -> "Generator":
        with self._lock:
            self._seed = int(seed)
            self._counter = 0
            for g in self._gens.values():
                g.manual_seed(self._seed)
        return self

    def generator(self, device=None) -> torch.Generator:
        """The ``torch.Generator`` of ``device`` (default: the default
        device), which draws on that device take."""
        dev = _dev(device)
        with self._lock:
            g = self._gens.get(dev)
            if g is None:
                g = self._gens[dev] = torch.Generator(dev).manual_seed(self._seed)
            return g

    def next_key(self, device=None) -> torch.Generator:
        """A new ``torch.Generator`` on ``device``, forked from this
        generator's CPU stream (so the same on every device)."""
        cpu = self.generator("cpu")
        with self._lock:
            self._counter += 1
            return _fork(cpu, _dev(device))

    def split(self, n: int) -> List["Generator"]:
        """``n`` new generators, seeded by ``n`` draws of this one's CPU
        stream."""
        cpu = self.generator("cpu")
        with self._lock:
            self._counter += n
            seeds = torch.randint(_SEED_BOUND, (n,), generator=cpu).tolist()
        return [Generator(s) for s in seeds]

    @property
    def initial_seed(self) -> int:
        return self._seed

    def get_state(self) -> dict:
        """The seed, the draw count and every device's generator state."""
        with self._lock:
            return {"seed": self._seed, "counter": self._counter,
                    "states": {str(d): g.get_state() for d, g in self._gens.items()}}

    def set_state(self, state: dict) -> None:
        with self._lock:
            self._seed = int(state["seed"])
            self._counter = int(state["counter"])
            states = {torch.device(name): st for name, st in state["states"].items()}
            for dev, g in self._gens.items():
                if dev not in states:       # made after the state was taken: fresh again
                    g.manual_seed(self._seed)
            for dev, st in states.items():
                g = self._gens.get(dev)
                if g is None:
                    g = self._gens[dev] = torch.Generator(dev)
                g.set_state(st)


class _TorchDefaultGenerator(Generator):
    """torch's global generators, one a device: the default of every draw
    given no generator."""

    def __init__(self):
        self._lock = threading.Lock()
        self._gens = {}
        self._seed = _DEFAULT_SEED
        self._counter = 0

    def manual_seed(self, seed: int) -> "Generator":
        with self._lock:
            self._seed = int(seed)
            self._counter = 0
            torch.manual_seed(self._seed)
        return self

    def generator(self, device=None) -> torch.Generator:
        dev = _dev(device)
        if dev.type == "cpu":
            return torch.default_generator
        torch.cuda.init()
        return torch.cuda.default_generators[dev.index]

    def _devices(self) -> List[torch.device]:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return [torch.device("cpu")] + [torch.device("cuda", i) for i in range(cards)]

    def get_state(self) -> dict:
        return {"seed": self._seed, "counter": self._counter,
                "states": {str(d): self.generator(d).get_state() for d in self._devices()}}

    def set_state(self, state: dict) -> None:
        self._seed = int(state["seed"])
        self._counter = int(state["counter"])
        for name, st in state["states"].items():
            self.generator(torch.device(name)).set_state(st)


default_generator = _TorchDefaultGenerator()

_scopes = threading.local()

KeyLike = Union[Generator, torch.Generator, int]


class key_scope:
    """Draws inside take ``key``'s stream: a :class:`Generator`, a
    ``torch.Generator`` (its device's draws only) or an int seed (a new
    :class:`Generator`).  The reference's counterpart hands traced code a
    base key to fold per draw; the eager port needs only the stream."""

    def __init__(self, key: KeyLike):
        self._key = Generator(key) if isinstance(key, int) else key

    def __enter__(self):
        stack = getattr(_scopes, "stack", None)
        if stack is None:
            stack = _scopes.stack = []
        stack.append(self._key)
        return self

    def __exit__(self, *exc):
        _scopes.stack.pop()


def _scoped() -> Optional[KeyLike]:
    stack = getattr(_scopes, "stack", None)
    return stack[-1] if stack else None


def generator_for(device, generator: Optional[KeyLike] = None) -> Optional[torch.Generator]:
    """The ``torch.Generator`` a draw on ``device`` takes: ``generator``'s,
    else the innermost :class:`key_scope`'s, else None (the device's global
    generator)."""
    src = generator if generator is not None else _scoped()
    if src is None:
        return None
    if isinstance(src, torch.Generator):
        if src.device.type != torch.device(device).type:
            raise ValueError(f"a {src.device} generator cannot draw on {device}")
        return src
    return src.generator(device)


def _keep_mask(shape, keep_prob: float, device, generator: Optional[KeyLike] = None
               ) -> torch.Tensor:
    """A bool mask of ``shape`` on ``device``, each element True with
    probability ``keep_prob``, drawn from :func:`generator_for`'s generator
    (a uniform draw below ``keep_prob``; Philox on the card)."""
    gen = generator_for(device, generator)
    return torch.rand(tuple(shape), device=device, generator=gen) < keep_prob


def _uniform(shape, low: float, high: float, device,
             generator: Optional[KeyLike] = None) -> torch.Tensor:
    """f32 values of ``shape`` on ``device``, uniform in [low, high), drawn
    as :func:`_keep_mask` draws."""
    gen = generator_for(device, generator)
    return torch.empty(tuple(shape), device=device).uniform_(low, high, generator=gen)


def seed(value: int) -> Generator:
    """Seed every device's global generator (``paddle.seed``), offset by
    the process rank of ``torch.distributed`` when ``seed_offset_by_rank``
    is on.  Returns :data:`default_generator`."""
    dist = torch.distributed
    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    offset = rank if get_flags("seed_offset_by_rank")["seed_offset_by_rank"] else 0
    return default_generator.manual_seed(int(value) + offset)


def next_key(generator: Optional[KeyLike] = None, *, device=None) -> torch.Generator:
    """A new ``torch.Generator`` on ``device`` (default: the default
    device), forked from ``generator``, else the innermost
    :class:`key_scope`'s, else :data:`default_generator`."""
    src = generator if generator is not None else _scoped()
    if isinstance(src, torch.Generator):
        return _fork(src, _dev(device))
    return (src or default_generator).next_key(device)


def get_rng_state() -> dict:
    """Every device's global generator state."""
    return default_generator.get_state()


def set_rng_state(state: dict) -> None:
    default_generator.set_state(state)


def bulk_key(key):
    """``key`` itself: the reference's ``rbg`` view for dropout masks has no
    counterpart, torch's CUDA generator being counter-based already."""
    return key
