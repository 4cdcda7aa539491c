"""Serving: class-conditional images (CIFAR-10, MNIST and PGGAN) from a
trained generator over HTTP, ported from ``rcgan_tpu/serving.py``.

What carries over unchanged in behaviour:

- **Batch-size buckets**: a request runs at the smallest covering bucket
  (pad-and-slice); requests above the largest bucket stream through it.
- **Cross-client coalescing**: concurrent ``/sample`` requests are merged
  into one generator pass by a per-model :class:`Coalescer`.  Each
  request's latent ``z`` is drawn on the host from its own seed with numpy,
  exactly as in JAX, so ``sample_with_z`` and ``Coalescer.submit`` give
  the same images in both frameworks on the same weights.
- **HTTP endpoint** (stdlib, threaded): ``/healthz``, ``/models``,
  ``/metrics``, ``/sample``; a model registry and optional bearer auth.

What differs:

- weights come from the port's own checkpoints, as JAX's sampler restores
  its trainers' (``<run>/checkpoint`` of an ``apps/cifar_app.py`` run,
  ``<run>/ckpt`` of an ``apps/mnist_app.py`` or ``apps/pggan_app.py`` run;
  ``train_state.pt``), into a train state built from the run's
  ``config.json`` and ``--algorithm``: an rcgan-u CIFAR run carries the
  ``confusion`` group, and ``perm_classifier`` the perm classifier.  A JAX
  CIFAR run is served from ``<dir>/generator.npz`` (written from its orbax
  checkpoint by ``scripts/export_generator_npz.py``, where JAX runs), the
  route taken where ``<dir>`` holds that file;
- the MNIST sampler draws U[-1, 1] latents and runs G with BN in inference
  mode; its sigmoid output is already in [0, 1];
- the PGGAN sampler runs G at the schedule's last stage
  (``4 * 2**max_stage`` pixels, NHWC), cond-BN on the bucket's batch
  statistics, as the CIFAR sampler;
- ``--export`` (``jax.export``) is not ported (ROADMAP.md);
- PNGs are encoded with the standard library (``zlib`` + ``struct``,
  ``utils/images.py::encode_png``);
- labels outside ``[0, n_labels)`` are refused (HTTP 400) before they
  reach the device, where JAX's gather would have filled them silently.

On a CUDA device the CIFAR and PGGAN generators run through the
hand-written cond-BN and 3x3-conv kernels; the MNIST generator's linears, BNs and 5x5
transposed convs run on cuBLAS and cuDNN, as JAX leaves them to XLA.
On a card each bucket's generator pass is captured into a CUDA graph at
its first use and replayed after (``train/graphs.py``; JAX's sampler is
"compiled once per bucket size"), reading ``z`` and the labels from the
bucket's fixed buffers; the CPU runs the same pass eagerly on the same
buffers.  Constructing a :class:`Sampler` applies the port's float32 policy
(``core.module.float32_policy``: TF32 off for cuDNN convolutions and
cuBLAS matmuls), so float32 serving is float32 throughout, as it is in
JAX.

CLI:  python -m rcgan_tpu_torch.serving --model {cifar,mnist,pggan} --checkpoint_dir D \\
        [--algorithm A] [--labels 0,1,2 --n 100 --out grid.png] [--serve --port 8321] \\
        [--register name=cifar:dir ...] [--auth_token TOK] \\
        [--coalesce_wait_ms 4] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import threading
import time
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from rcgan_tpu_torch.bridge import generator_from_jax, load_npz
from rcgan_tpu_torch.core.module import float32_policy
from rcgan_tpu_torch.models import dcgan, pggan
from rcgan_tpu_torch.models.resnet_gan import Generator, ResnetGANConfig, sample
from rcgan_tpu_torch.train.graphs import CapturedStep, StepBlock, state_key
from rcgan_tpu_torch.utils.images import encode_png, merge

DEFAULT_BUCKETS = (1, 8, 32, 100)


def _restore_latest(trainer, checkpoint_dir: str):
    """The latest checkpoint under ``checkpoint_dir`` restored into a fresh
    train state of ``trainer``; ``FileNotFoundError`` when there is none."""
    from rcgan_tpu_torch.train.checkpoint import Checkpointer

    ts = trainer.init()
    restored = Checkpointer(checkpoint_dir).restore(ts) if os.path.isdir(checkpoint_dir) \
        else None
    if restored is None:
        raise FileNotFoundError(f"no checkpoint under {checkpoint_dir}")
    return restored


def _cifar_generator(checkpoint_dir: str, run_cfg: dict, pick, device) -> Generator:
    """The generator of the latest checkpoint of a CIFAR app run under
    ``checkpoint_dir`` (``<run>/checkpoint``), float32, in a train state
    built as JAX's ``"cifar"`` branch builds its template: the algorithm
    (the run's, or the override) decides the ``confusion`` group,
    ``perm_classifier`` the perm classifier, ``opt_moment_dtype`` the Adam
    moments' dtype."""
    from rcgan_tpu_torch.algorithms.cifar import CifarAlgoConfig
    from rcgan_tpu_torch.data.confusion import one_coin_matrix
    from rcgan_tpu_torch.train.cifar_loop import CifarTrainConfig, CifarTrainer

    mkw = pick(ResnetGANConfig)
    mkw.setdefault("algorithm", "rcgan")
    cfg = ResnetGANConfig(**mkw)
    akw = pick(CifarAlgoConfig)
    akw["algorithm"] = cfg.algorithm
    tcfg = CifarTrainConfig(moment_dtype=run_cfg.get("opt_moment_dtype"))
    # the true C plays no part in sampling
    trainer = CifarTrainer(cfg, CifarAlgoConfig(**akw), tcfg, one_coin_matrix(0.6, 10),
                           device=device)
    return _restore_latest(trainer, checkpoint_dir).gan.G


def _mnist_generator(checkpoint_dir: str, run_cfg: dict, pick, device) -> "dcgan.Generator":
    """The generator of the latest MNIST checkpoint under ``checkpoint_dir``
    (``train/checkpoint.py`` layout), in a train state built from the run's
    flags (JAX's ``from_checkpoint`` ``"mnist"`` branch)."""
    from rcgan_tpu_torch.algorithms.mnist import MnistAlgoConfig
    from rcgan_tpu_torch.train.mnist_loop import MnistTrainConfig, MnistTrainer

    mkw = pick(dcgan.DCGANConfig)
    if "concat_y_layers" in mkw:
        mkw["concat_y_layers"] = tuple(int(x) for x in mkw["concat_y_layers"])
    akw = pick(MnistAlgoConfig)
    # the MNIST CLI takes perm_regularizer as --aux_classifier too
    if run_cfg.get("aux_classifier") is not None:
        akw.setdefault("perm_regularizer", bool(run_cfg["aux_classifier"]))
    # the true C plays no part in sampling
    trainer = MnistTrainer(dcgan.DCGANConfig(**mkw), MnistAlgoConfig(**akw), MnistTrainConfig(),
                           np.eye(10, dtype=np.float32), device=device)
    return _restore_latest(trainer, checkpoint_dir).gan.G


def _pggan_generator(checkpoint_dir: str, pick, device) -> "pggan.Generator":
    """The generator of the latest PGGAN checkpoint under ``checkpoint_dir``
    (``apps/pggan_app.py``'s phase checkpoints), in a train state built from
    the run's ``PGGANConfig`` fields, float32 (JAX's ``"pggan"`` branch)."""
    from rcgan_tpu_torch.train.pggan_loop import PGGANTrainConfig, PGGANTrainer

    cfg = pggan.PGGANConfig(**pick(pggan.PGGANConfig))
    base = ResnetGANConfig(dim_g=cfg.dim, dim_d=cfg.dim, z_dim=cfg.z_dim)
    trainer = PGGANTrainer(cfg, base, PGGANTrainConfig(), device=device)
    return _restore_latest(trainer, checkpoint_dir).gan.G


def _load_run_config(checkpoint_dir: str) -> dict:
    """The apps archive every flag as ``config.json`` in the run dir; the
    checkpoint lives one level below (``<run>/ckpt`` or ``<run>/checkpoint``).
    Search the checkpoint dir and two ancestors."""
    d = os.path.abspath(checkpoint_dir)
    for _ in range(3):
        path = os.path.join(d, "config.json")
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        d = os.path.dirname(d)
    return {}


class Sampler:
    """Generator-backed conditional sampler with bucketed batch shapes
    (pad-and-slice for ragged requests).  ``generator`` is the CIFAR
    ``Generator`` (``model`` "cifar"), the MNIST ``dcgan.Generator``
    ("mnist") or the PGGAN ``pggan.Generator`` ("pggan")."""

    def __init__(self, generator, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 graphs: Optional[bool] = None):
        float32_policy(torch.float32)  # serving is float32 throughout
        self.generator = generator
        self.buckets = tuple(sorted(buckets))
        self.cfg = generator.cfg
        if isinstance(generator, dcgan.Generator):
            self.model, self.n_labels = "mnist", self.cfg.y_dim
        elif isinstance(generator, pggan.Generator):
            self.model, self.n_labels = "pggan", generator.base.vocab_size
        else:
            self.model, self.n_labels = "cifar", self.cfg.vocab_size
        self.z_dim = self.cfg.z_dim
        self.device = next(generator.parameters()).device
        on_card = self.device.type == "cuda"
        if graphs and not on_card:
            raise ValueError(f"CUDA graphs need a CUDA device; the generator is on {self.device}")
        self.graphs = on_card if graphs is None else bool(graphs)
        self.passes = 0  # generator passes run, one per bucketed chunk
        self._passes_lock = threading.Lock()
        # one (StepBlock, CapturedStep) per bucket size; the lock covers a
        # pass's copy in, its run or replay and its copy out, since the
        # coalescer's worker and the HTTP handlers share the buffers
        self._passes_at: Dict[int, tuple] = {}
        self._pass_lock = threading.Lock()

    @classmethod
    def from_checkpoint(cls, model: str, checkpoint_dir: str,
                        buckets: Sequence[int] = DEFAULT_BUCKETS, device="cuda",
                        **overrides):
        """Config resolution, lowest to highest precedence: the config
        dataclasses' defaults < the run's archived ``config.json`` (found
        next to ``checkpoint_dir``) < explicit ``overrides`` (such as
        ``algorithm=``).  Each model restores the latest checkpoint of its
        app's run under ``checkpoint_dir`` and keeps its generator,
        float32; ``cifar`` loads ``<checkpoint_dir>/generator.npz`` (a JAX
        run's, exported) instead where that file exists.  No checkpoint
        raises ``FileNotFoundError``; ``device="cuda"`` without a card
        raises."""
        run_cfg = dict(_load_run_config(checkpoint_dir))
        run_cfg.update(overrides)

        def pick(dc_type):
            fields = {f.name for f in dataclasses.fields(dc_type)}
            return {k: v for k, v in run_cfg.items() if k in fields}

        if model == "mnist":
            return cls(_mnist_generator(checkpoint_dir, run_cfg, pick, device), buckets)
        if model == "pggan":
            return cls(_pggan_generator(checkpoint_dir, pick, device), buckets)
        if model != "cifar":
            raise ValueError(f"unknown model {model!r}")
        path = os.path.join(checkpoint_dir, "generator.npz")
        if os.path.exists(path):  # a JAX run's generator
            cfg = ResnetGANConfig(**pick(ResnetGANConfig))
            return cls(generator_from_jax(load_npz(path), cfg, device), buckets)
        try:
            return cls(_cifar_generator(checkpoint_dir, run_cfg, pick, device), buckets)
        except FileNotFoundError:
            raise FileNotFoundError(f"no checkpoint of a CIFAR app run and no generator.npz "
                                    f"under {checkpoint_dir} (a JAX run's: export it with "
                                    "scripts/export_generator_npz.py)") from None

    # ----------------------------------------------------------- internals
    def check_labels(self, labels: Sequence[int]) -> np.ndarray:
        """Labels as int64, refused (ValueError) outside ``[0, n_labels)``:
        the device gathers by label without bounds checks."""
        out = np.asarray(labels)
        if out.ndim != 1 or (out.size and not np.issubdtype(out.dtype, np.integer)):
            raise ValueError("labels must be a 1-D sequence of ints")
        out = out.astype(np.int64)
        if out.size and (out.min() < 0 or out.max() >= self.n_labels):
            raise ValueError(f"labels must lie in [0, {self.n_labels})")
        return out

    def draw_z(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """Latents in the model's training prior (MNIST U[-1, 1], CIFAR
        N(0, 1)), drawn host-side so a request's z is a pure function of its
        own seed — the property coalescing relies on."""
        if self.model == "mnist":
            return rng.uniform(-1.0, 1.0, (n, self.z_dim)).astype(np.float32)
        return rng.standard_normal((n, self.z_dim)).astype(np.float32)

    def _pass(self, block: StepBlock) -> torch.Tensor:
        """The generator pass on the bucket's block: what a graph captures."""
        z, labels = block.row("z"), block.row("labels")
        if self.model == "mnist":
            y = torch.nn.functional.one_hot(labels, self.n_labels).float()
            return dcgan.sample(self.generator, z, y)
        if self.model == "pggan":  # NHWC at the schedule's last stage
            return pggan.sample(self.generator, z, labels)
        return sample(self.generator, z, labels)

    def _run_batch_z(self, z, padded: np.ndarray) -> np.ndarray:
        """One generator pass at len(padded) (a bucket size), explicit z:
        ``[B, H, W, C]`` float32.  The bucket's inputs are copied into its
        fixed buffers, then its pass runs, replayed from a CUDA graph on a
        card (captured at the bucket's first pass: JAX's "compiled once per
        bucket size")."""
        n = len(padded)
        key = state_key(list(self.generator.parameters()) + list(self.generator.buffers()))
        with self._pass_lock:
            if n not in self._passes_at:
                block = StepBlock({"z": (torch.float32, (n, self.z_dim)),
                                   "labels": (torch.int64, (n,))}, 1, self.device)
                self._passes_at[n] = (block, CapturedStep(functools.partial(self._pass, block),
                                                          self.device, self.graphs))
            block, step = self._passes_at[n]
            block.load({"z": np.asarray(z, np.float32)[None], "labels": padded[None]})
            out = step(key, held=self.generator).cpu().numpy()
        if self.model == "cifar":
            c = self.cfg
            out = out.reshape(-1, c.img_size, c.img_size, c.img_dim)
        with self._passes_lock:
            self.passes += 1
        return out

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _run_chunks(self, labels: np.ndarray, z_for) -> np.ndarray:
        """The bucketing policy: stream ``labels`` through the largest bucket,
        run each chunk at its covering bucket padded with label 0, and slice
        the pads back off.  ``z_for(start, n, bucket)`` gives the chunk's
        ``[bucket, z_dim]`` latents."""
        big = self.buckets[-1]
        outs = []
        for i in range(0, len(labels), big):
            chunk = labels[i : i + big]
            bucket = self._bucket_for(len(chunk))
            padded = np.concatenate([chunk, np.zeros(bucket - len(chunk), np.int64)])
            img = self._run_batch_z(z_for(i, len(chunk), bucket), padded)
            outs.append(img[: len(chunk)])
        return np.concatenate(outs)

    def sample_with_z(self, z: np.ndarray, labels: Sequence[int]) -> np.ndarray:
        """Like :meth:`sample` but with caller-provided latents [N, z_dim]
        (the coalescer path); pads are zero latents."""
        labels = self.check_labels(labels)
        if len(z) != len(labels):
            raise ValueError(f"{len(z)} latents for {len(labels)} labels")
        return self._run_chunks(labels, lambda i, n, bucket: np.concatenate(
            [z[i : i + n], np.zeros((bucket - n, self.z_dim), np.float32)]))

    def sample(self, labels: Sequence[int],
               generator: Optional[torch.Generator] = None) -> np.ndarray:
        """Generate one image per label: ``[N, 32, 32, 3]`` in [-1, 1]
        (CIFAR), ``[N, R, R, 3]`` in [-1, 1] at ``R = 4 * 2**max_stage``
        (PGGAN) or ``[N, 28, 28, 1]`` in [0, 1] (MNIST).  z is drawn per
        bucketed chunk from ``generator`` (a CPU ``torch.Generator``; seed 0
        when None), in the model's prior.  That stream differs from JAX's
        ``jax.random`` stream, so this path is not comparable across the two
        frameworks; :meth:`sample_with_z` is."""
        gen = torch.Generator().manual_seed(0) if generator is None else generator

        def z_for(i, n, bucket):
            if self.model == "mnist":
                return 2.0 * torch.rand((bucket, self.z_dim), generator=gen) - 1.0
            return torch.randn((bucket, self.z_dim), generator=gen)

        return self._run_chunks(self.check_labels(labels), z_for)


# ------------------------------------------------------ metrics middleware
class ServingMetrics:
    """Thread-safe counters rendered in Prometheus text format at
    ``/metrics``.  Tracks per-model request counts/latency and the
    coalescer's batching efficiency (requests merged per device pass)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._requests: Dict[str, int] = {}
        self._samples: Dict[str, int] = {}
        self._seconds: Dict[str, float] = {}
        self._errors: Dict[str, int] = {}
        self._batches = 0
        self._batched_requests = 0
        self._coalesced_batches = 0

    def observe_request(self, model: str, seconds: float, n_samples: int):
        with self._lock:
            self._requests[model] = self._requests.get(model, 0) + 1
            self._samples[model] = self._samples.get(model, 0) + n_samples
            self._seconds[model] = self._seconds.get(model, 0.0) + seconds

    def observe_error(self, model: str):
        with self._lock:
            self._errors[model] = self._errors.get(model, 0) + 1

    def observe_batch(self, n_requests: int):
        with self._lock:
            self._batches += 1
            self._batched_requests += n_requests
            if n_requests > 1:
                self._coalesced_batches += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "requests": dict(self._requests),
                "samples": dict(self._samples),
                "errors": dict(self._errors),
                "batches_total": self._batches,
                "batched_requests_total": self._batched_requests,
                "coalesced_batches_total": self._coalesced_batches,
            }

    def render(self) -> str:
        s = self.snapshot()
        lines = [
            "# HELP rcgan_requests_total /sample requests served",
            "# TYPE rcgan_requests_total counter",
        ]
        for m, v in sorted(s["requests"].items()):
            lines.append(f'rcgan_requests_total{{model="{m}"}} {v}')
        lines += ["# TYPE rcgan_samples_total counter"]
        for m, v in sorted(s["samples"].items()):
            lines.append(f'rcgan_samples_total{{model="{m}"}} {v}')
        lines += ["# TYPE rcgan_request_seconds_sum counter"]
        with self._lock:
            for m, v in sorted(self._seconds.items()):
                lines.append(f'rcgan_request_seconds_sum{{model="{m}"}} {v:.6f}')
        lines += ["# TYPE rcgan_request_errors_total counter"]
        for m, v in sorted(s["errors"].items()):
            lines.append(f'rcgan_request_errors_total{{model="{m}"}} {v}')
        lines += [
            "# HELP rcgan_device_batches_total coalesced generator batches",
            "# TYPE rcgan_device_batches_total counter",
            f"rcgan_device_batches_total {s['batches_total']}",
            "# HELP rcgan_batched_requests_total requests summed over batches",
            "# TYPE rcgan_batched_requests_total counter",
            f"rcgan_batched_requests_total {s['batched_requests_total']}",
            "# HELP rcgan_coalesced_batches_total batches that merged >1 request",
            "# TYPE rcgan_coalesced_batches_total counter",
            f"rcgan_coalesced_batches_total {s['coalesced_batches_total']}",
        ]
        return "\n".join(lines) + "\n"


# ------------------------------------------------------ request coalescing
@dataclasses.dataclass
class _Pending:
    labels: np.ndarray
    z: np.ndarray
    event: threading.Event
    out: Optional[np.ndarray] = None
    err: Optional[BaseException] = None


class Coalescer:
    """Cross-client batch coalescing: concurrent requests enqueue and a
    single worker thread drains the queue into ONE ``sample_with_z`` call
    (which buckets/pads as usual), then scatters the outputs back.

    Per-request latents are drawn host-side from the request's own seed
    (:meth:`Sampler.draw_z`) BEFORE merging, so what a request gets does not
    depend on its batch-mates (up to cond-BN's batch statistics).  The
    worker waits ``max_wait_ms`` after the first enqueue to let concurrent
    requests pile in.
    """

    def __init__(self, sampler: Sampler, max_wait_ms: float = 4.0,
                 metrics: Optional[ServingMetrics] = None):
        self.sampler = sampler
        self._wait_s = max_wait_ms / 1e3
        self.metrics = metrics
        self._cv = threading.Condition()
        self._queue: list = []
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, labels: Sequence[int], seed: int, timeout: float = 300.0) -> np.ndarray:
        """Images for ``labels`` with z from ``seed``.  Bad labels raise
        ValueError here, before they can fail the requests batched with them."""
        labels = self.sampler.check_labels(labels)
        rng = np.random.default_rng(seed)
        req = _Pending(labels=labels, z=self.sampler.draw_z(rng, len(labels)),
                       event=threading.Event())
        with self._cv:
            if self._stop:
                raise RuntimeError("coalescer closed")
            self._queue.append(req)
            self._cv.notify()
        if not req.event.wait(timeout):
            raise TimeoutError("sample request timed out")
        if req.err is not None:
            raise req.err
        return req.out

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=5.0)

    def _loop(self):
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait(0.25)
                if self._stop and not self._queue:
                    return
            time.sleep(self._wait_s)  # gather window
            with self._cv:
                reqs, self._queue = self._queue, []
            if not reqs:
                continue
            try:
                z = np.concatenate([r.z for r in reqs])
                labels = np.concatenate([r.labels for r in reqs])
                imgs = self.sampler.sample_with_z(z, labels)
                i = 0
                for r in reqs:
                    r.out = imgs[i : i + len(r.labels)]
                    i += len(r.labels)
            except Exception as e:  # noqa: BLE001 — each caller re-raises it
                for r in reqs:
                    r.err = e
            if self.metrics is not None:
                self.metrics.observe_batch(len(reqs))
            for r in reqs:
                r.event.set()


# ------------------------------------------------------------------ HTTP
# Request-size ceiling for the HTTP endpoint: a huge ?n= would block the
# device and exhaust memory.
MAX_REQUEST_SAMPLES = 1024


def to_unit_range(imgs: np.ndarray, model: str = "cifar") -> np.ndarray:
    """Generator output range → [0,1] for PNG encoding.  MNIST's sigmoid
    head already is; the CIFAR and PGGAN generators end in tanh ([-1,1]),
    whose negative half clipping would zero."""
    return imgs if model == "mnist" else (imgs + 1.0) / 2.0


def _png(img: np.ndarray) -> bytes:
    """8-bit PNG of ``img`` in [0,1]: ``[H,W,3]`` RGB or ``[H,W]`` grey."""
    return encode_png((np.clip(img, 0.0, 1.0) * 255).astype(np.uint8))


def _to_png_grid(imgs: np.ndarray) -> bytes:
    # ceil-sided grid padded with blank tiles so every requested image appears
    n = len(imgs)
    side = max(1, int(np.ceil(np.sqrt(n))))
    if side * side > n:
        pad = np.zeros((side * side - n,) + imgs.shape[1:], imgs.dtype)
        imgs = np.concatenate([imgs, pad], axis=0)
    return _png(merge(imgs, (side, side)))


def make_server(models: Union[Sampler, Dict[str, Sampler]], port: int = 8321,
                host: str = "127.0.0.1", auth_token: Optional[str] = None,
                coalesce_wait_ms: float = 4.0,
                metrics: Optional[ServingMetrics] = None):
    """Threaded stdlib HTTP server over a model registry.

    - ``GET /healthz`` — liveness (never auth-gated).
    - ``GET /models`` — JSON list of registered model names.
    - ``GET /metrics`` — Prometheus text.
    - ``GET /sample?labels=1,2,3&seed=0[&model=name]`` (or ``?n=16``) —
      PNG grid.  Concurrent requests to one model are coalesced.
    - ``auth_token``: if set, every endpoint but ``/healthz`` requires
      ``Authorization: Bearer <token>`` (or ``?token=``).

    ``models`` may be a single :class:`Sampler` (registered as
    ``"default"``) or a name→Sampler dict.  The returned server exposes
    ``.metrics`` and ``.coalescers`` and shuts the workers down on
    ``server_close()``.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    registry = {"default": models} if isinstance(models, Sampler) else dict(models)
    if not registry:
        raise ValueError("empty model registry")
    default_name = "default" if "default" in registry else sorted(registry)[0]
    mx = metrics if metrics is not None else ServingMetrics()
    coalescers = {
        name: Coalescer(s, max_wait_ms=coalesce_wait_ms, metrics=mx)
        for name, s in registry.items()
    }

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="text/plain"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _authorized(self, q) -> bool:
            if auth_token is None:
                return True
            header = self.headers.get("Authorization", "")
            if header == f"Bearer {auth_token}":
                return True
            return q.get("token", [None])[0] == auth_token

        def do_GET(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            if url.path == "/healthz":
                return self._send(200, b"ok")
            if not self._authorized(q):
                return self._send(401, b"unauthorized")
            if url.path == "/models":
                body = json.dumps(sorted(registry)).encode()
                return self._send(200, body, "application/json")
            if url.path == "/metrics":
                return self._send(200, mx.render().encode(),
                                  "text/plain; version=0.0.4")
            if url.path != "/sample":
                return self._send(404, b"not found")
            name = q.get("model", [default_name])[0]
            if name not in registry:
                return self._send(404, b"unknown model %s" % name.encode())
            try:
                if "labels" in q:
                    labels = [int(x) for x in q["labels"][0].split(",")]
                else:
                    n = int(q.get("n", ["16"])[0])
                    if not 1 <= n <= MAX_REQUEST_SAMPLES:
                        return self._send(
                            400, b"n out of range (1..%d)" % MAX_REQUEST_SAMPLES)
                    labels = list(np.arange(n) % registry[name].n_labels)
                seed = int(q.get("seed", ["0"])[0])
            except ValueError:
                return self._send(400, b"bad labels/seed")
            if len(labels) > MAX_REQUEST_SAMPLES:
                return self._send(
                    400, b"too many samples requested (max %d)" % MAX_REQUEST_SAMPLES)
            t0 = time.perf_counter()
            try:
                imgs = coalescers[name].submit(labels, seed)
            except ValueError as e:
                return self._send(400, str(e).encode())
            except Exception:  # noqa: BLE001 — the server keeps serving
                mx.observe_error(name)
                return self._send(500, b"sampling failed")
            mx.observe_request(name, time.perf_counter() - t0, len(labels))
            imgs = to_unit_range(imgs, registry[name].model)
            return self._send(200, _to_png_grid(imgs), "image/png")

    class Server(ThreadingHTTPServer):
        daemon_threads = True

        def server_close(self):
            for c in coalescers.values():
                c.close()
            super().server_close()

    srv = Server((host, port), Handler)
    srv.metrics = mx
    srv.coalescers = coalescers
    return srv


def main(argv=None):
    p = argparse.ArgumentParser(description="rcgan_tpu_torch sampler")
    p.add_argument("--model", choices=["mnist", "cifar", "pggan"], required=True)
    p.add_argument("--checkpoint_dir", required=True,
                   help="the run's checkpoint directory (cifar: <run>/checkpoint, or a "
                        "directory holding generator.npz; mnist, pggan: <run>/ckpt), with "
                        "config.json here or up to two levels above")
    p.add_argument("--labels", default=None, help="comma-separated class ids")
    p.add_argument("--n", type=int, default=100)
    p.add_argument("--out", default="samples.png")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--serve", action="store_true", help="run the HTTP endpoint")
    p.add_argument("--port", type=int, default=8321)
    p.add_argument("--algorithm", default=None,
                   help="override the checkpoint's training algorithm (usually "
                        "auto-detected from the run's config.json)")
    p.add_argument("--register", action="append", default=[],
                   metavar="NAME=MODEL:CKPT_DIR",
                   help="register extra models on the HTTP registry (repeatable)")
    p.add_argument("--auth_token", default=None,
                   help="require Authorization: Bearer <token> on every "
                        "endpoint except /healthz")
    p.add_argument("--coalesce_wait_ms", type=float, default=4.0,
                   help="gather window for cross-client request coalescing")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = p.parse_args(argv)

    overrides = {} if args.algorithm is None else {"algorithm": args.algorithm}
    sampler = Sampler.from_checkpoint(args.model, args.checkpoint_dir, device=args.device,
                                      **overrides)

    if args.serve:
        registry = {"default": sampler}
        for spec in args.register:
            try:
                name, rest = spec.split("=", 1)
                kind, ckpt = rest.split(":", 1)
            except ValueError:
                raise SystemExit(f"bad --register spec {spec!r} "
                                 "(want NAME=MODEL:CKPT_DIR)")
            registry[name] = Sampler.from_checkpoint(kind, ckpt, device=args.device)
        srv = make_server(registry, args.port, auth_token=args.auth_token,
                          coalesce_wait_ms=args.coalesce_wait_ms)
        print(f"serving {sorted(registry)} on http://127.0.0.1:{args.port} "
              "(/healthz, /models, /metrics, /sample)")
        try:
            srv.serve_forever()
        finally:
            srv.server_close()
        return

    if args.labels:
        labels = [int(x) for x in args.labels.split(",")]
    else:
        labels = list(np.arange(args.n) % 10)
    imgs = sampler.sample(labels, torch.Generator().manual_seed(args.seed))
    imgs = to_unit_range(imgs, sampler.model)
    side = int(np.floor(np.sqrt(len(imgs))))
    with open(args.out, "wb") as f:
        f.write(_png(merge(imgs[: side * side], (side, side))))
    print(f"wrote {args.out} ({side}x{side} grid)")


if __name__ == "__main__":
    main()
