"""Training loop (port of the JAX package's ``trainer.py``).

Drives the train / validate / test / predict / export lifecycle:
  * fit: per step a camera batch from the data module (numpy draws, the
    per-pixel rays built on the trainer's device), one system
    train step on the device (with its structural update when due), metrics
    logged to ``metrics.jsonl`` on logged steps (which is where the host
    reads the losses), validation and checkpoints at their intervals;
    ``resume`` continues from a port checkpoint at its step;
  * fault tolerance (``trainer.fault_tolerance``): a step that fails writes
    ``ckpts/crash.ckpt.npz`` and is retried up to ``max_retries`` times
    after ``retry_wait_s``; programming errors and any failure of a hand
    kernel's build or launch (``ops.native.KernelError``) are raised at
    once, never retried; ``nan_patience`` logged steps in a row with a
    non-finite total loss save ``nan.ckpt.npz`` and raise;
  * validate / test: fixed-circle renders -> PNGs (-> video where imageio
    exists), and the point-cloud PLY after the test renders;
  * export: the exporter's PLY and mesh;
  * predict: the SuGaR system's textured-mesh bake (OBJ + MTL + PNG);
    the other systems have no predict surface and run the test renders;
  * spans (``utils/tracing.py``) around the data batch, the train step,
    each logged value's host read, the metrics row, validation and
    checkpoints, recorded while a torch profiler runs;
  * wandb (``loggers.wandb``, at the top level or under ``system:``): with
    ``enable: true`` each metrics row also goes to a wandb run, finished at
    the end of ``fit``; a wandb that does not import or initialise is
    reported and the run goes on without it (a logger changes no result).

Multi-rank runs (one process per rank under ``torchrun``; ``launch.py``
initialises the group): ``trainer.devices`` keeps the JAX trainer's
meaning.  "auto" (the default) shards the camera batch over every rank when
there is more than one; N requires N ranks, and N = 1 forces the
data-parallel step on a one-rank group (initialised here when none exists,
and destroyed by ``close``); 0 keeps the one-process step.  Every rank
trains the same replicated state; rank 0 alone writes (metrics, PNGs,
checkpoints, PLYs, exports) and renders the evaluation views, the others
waiting at a barrier.  Every rank prints its logged losses; rank 0 alone
logs to wandb.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .ops.native import KernelError
from .parallel.mesh import initialize_distributed, make_mesh
from .utils.ckpt import load_checkpoint, save_checkpoint
from .utils.config import ExperimentConfig, dump_config
from .utils.registry import find
from .utils.saving import save_image_grid, save_img_sequence
from .utils.tracing import host_read, span


# failures that a retry cannot cure: raised at once
NOT_RETRIED = (TypeError, ValueError, AttributeError, KeyError, IndexError, AssertionError,
               KernelError)


def _host(v: Any) -> float:
    if isinstance(v, torch.Tensor):
        return float(host_read(v.detach(), "fit/host_read"))
    return float(v)


class Trainer:
    def __init__(self, cfg: ExperimentConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.data = find(cfg.data_type)(cfg.data, seed=cfg.seed, device=self.device)
        self.system = find(cfg.system_type)(dict(cfg.system), device=self.device)
        # a temporal system conditions its guidance on the video frames
        if hasattr(self.system, "attach_video_frames") and hasattr(self.data, "rgbs"):
            self.system.attach_video_frames(self.data.rgbs)
        self.max_steps = int(cfg.trainer.get("max_steps", 1000))
        self.val_interval = cfg.trainer.get("val_check_interval", None)
        self.log_every = int(cfg.trainer.get("log_every_n_steps", 10))
        ckpt_cfg = cfg.checkpoint or {}
        self.ckpt_every = ckpt_cfg.get("every_n_train_steps", None)
        self.ckpt_keep_all = int(ckpt_cfg.get("save_top_k", 0) or 0) == -1
        self.save_dir = cfg.trial_dir or "outputs/debug"
        self._owns_group = False
        self.mesh = self._build_mesh(cfg)
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.world = dist.get_world_size() if dist.is_initialized() else 1
        if self.rank == 0:
            os.makedirs(self.save_dir, exist_ok=True)
        if self.mesh is not None and hasattr(self.system, "set_mesh"):
            self.system.set_mesh(self.mesh)
            self._say(f"[trainer] data-parallel over {self.mesh.size()} device(s): {self.mesh}")
        ft = cfg.trainer.get("fault_tolerance", {}) or {}
        self.ft_max_retries = int(ft.get("max_retries", 1))
        self.ft_retry_wait_s = float(ft.get("retry_wait_s", 10.0))
        self.ft_nan_patience = int(ft.get("nan_patience", 3))
        self.state = None
        self.step = 0
        self.metrics_log = []
        self.wandb_run = self._init_wandb(cfg) if self.rank == 0 else None

    def _build_mesh(self, cfg: ExperimentConfig):
        """The camera-sharded training mesh of ``trainer.devices`` (module
        docstring), or None for the one-process step."""
        devices = cfg.trainer.get("devices", "auto")
        world = dist.get_world_size() if dist.is_initialized() else 1
        if devices in ("auto", None, ""):
            if world <= 1:
                return None  # the one-process step, unchanged
        else:
            n = int(devices)
            if n <= 0:
                return None
            if n != world:
                raise ValueError(f"trainer.devices={n} but the process group has {world} "
                                 f"rank(s): start {n} with torchrun")
            if not dist.is_initialized():
                backend = "nccl" if self.device.type == "cuda" else "gloo"
                self._owns_group = initialize_distributed(backend, world_size=1, rank=0,
                                                          force=True)
        return make_mesh((world,), ("data",), device_type=self.device.type)

    def close(self) -> None:
        """Destroy the one-rank group ``trainer.devices=1`` initialised."""
        if self._owns_group:
            dist.destroy_process_group()
            self._owns_group = False

    def _say(self, msg: str) -> None:
        if self.rank == 0:
            print(msg, flush=True)

    def _rank0(self, fn):
        """``fn()`` on rank 0 alone, the other ranks waiting at a barrier:
        its result on rank 0, None on the others."""
        result = fn() if self.rank == 0 else None
        if self.world > 1:
            dist.barrier()
        return result

    def _init_wandb(self, cfg: ExperimentConfig):
        """The wandb run of ``loggers.wandb`` when it is enabled, else None
        (and wandb is not imported)."""
        loggers = cfg.loggers or (cfg.system or {}).get("loggers", {}) or {}
        wb_cfg = loggers.get("wandb", {})
        if not wb_cfg.get("enable", False):
            return None
        try:
            import wandb

            return wandb.init(
                project=wb_cfg.get("project", "threestudio-3dgs-tpu"),
                name=wb_cfg.get("name", cfg.trial_name) or cfg.trial_name,
                config=dict(cfg.__dict__),
                dir=self.save_dir,
            )
        except Exception as e:  # not installed, or no login or network
            print(f"[trainer] wandb disabled ({e})", flush=True)
            return None

    def _log_metrics(self, row: Dict[str, Any]) -> None:
        self.metrics_log.append(row)
        if self.rank == 0:
            with open(os.path.join(self.save_dir, "metrics.jsonl"), "a") as f:
                f.write(json.dumps(row) + "\n")
        if self.wandb_run is not None:
            self.wandb_run.log(row, step=row["step"])

    def load_state(self, resume: Optional[str]) -> None:
        """The state of a port checkpoint (and its step), or a fresh init."""
        if resume:
            self.state, self.step = load_checkpoint(resume, self.device)
        else:
            self.state = self.system.init_state(self.cfg.seed)

    def fit(self, resume: Optional[str] = None, on_step: Optional[Callable[[], None]] = None):
        """Train to ``trainer.max_steps``; ``on_step()`` is called after each
        step (the launcher's ``--profile`` steps its profiler there)."""
        if self.rank == 0:
            dump_config(self.cfg, os.path.join(self.save_dir, "parsed.yaml"))
        if resume:
            self.load_state(resume)
            self._say(f"[trainer] resumed from {resume} at step {self.step}")
        if self.state is None:
            self.state = self.system.init_state(self.cfg.seed)
        generator = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        nan_streak = 0
        retries = 0
        t_start = time.time()
        while self.step < self.max_steps:
            t_step = time.perf_counter()
            with span("fit/data"):
                batch = self.data.train_batch(self.step)
            try:
                with span("fit/train_step"):
                    self.state, logs = self.system.train_step(self.state, batch, self.step,
                                                              generator)
            except NOT_RETRIED:
                raise
            except Exception as e:  # a device fault, an out-of-memory
                retries += 1
                self._crash_checkpoint(e)
                # one rank's retry would put its collectives out of step
                if retries > self.ft_max_retries or self.world > 1:
                    raise
                print(f"[trainer] retry {retries}/{self.ft_max_retries} in "
                      f"{self.ft_retry_wait_s:.0f}s", flush=True)
                time.sleep(self.ft_retry_wait_s)
                continue
            retries = 0
            self.step += 1

            if self.step % self.log_every == 0 or self.step == 1:
                logs_host = {k: _host(v) for k, v in logs.items()}
                total = logs_host.get("train/loss_total")
                if total is not None and not np.isfinite(total):
                    nan_streak += 1
                    if nan_streak >= self.ft_nan_patience:
                        self.save_ckpt("nan.ckpt.npz")
                        raise FloatingPointError(
                            f"train/loss_total non-finite on {nan_streak} consecutive "
                            f"logged steps (step {self.step}); state saved to nan.ckpt.npz"
                        )
                else:
                    nan_streak = 0
                logs_host["step"] = self.step
                logs_host["wall_s"] = round(time.time() - t_start, 3)
                # this step's batch, train step and structural update, up to
                # its losses on the host (one step when every step is logged)
                logs_host["step_s"] = round(time.perf_counter() - t_step, 6)
                with span("fit/log"):
                    self._log_metrics(logs_host)
                    msg = " ".join(f"{k}={v:.4g}" for k, v in sorted(logs_host.items()))
                    who = f" rank {self.rank}/{self.world}" if self.world > 1 else ""
                    print(f"[trainer{who}] {msg}", flush=True)

            if self.val_interval and self.step % int(self.val_interval) == 0:
                with span("fit/validate"):
                    self.validate()
            if self.ckpt_every and self.step % int(self.ckpt_every) == 0:
                with span("fit/checkpoint"):
                    if self.ckpt_keep_all:
                        self.save_ckpt(f"step{self.step}.ckpt.npz")
                    self.save_ckpt("last.ckpt.npz")
            if on_step is not None:
                on_step()
        self.save_ckpt("last.ckpt.npz")
        if self.wandb_run is not None:
            self.wandb_run.finish()
            self.wandb_run = None
        return self.state

    def _crash_checkpoint(self, error: Exception) -> None:
        """Save the state the failed step started from to crash.ckpt.npz
        (reported, not raised, if the state itself cannot be saved).  The
        Adam moments are updated in place, so a step that failed after its
        optimiser update leaves them, and its retry starts from, one
        update ahead."""
        if self.rank != 0:
            return
        path = os.path.join(self.save_dir, "ckpts", "crash.ckpt.npz")
        name = type(error).__name__
        try:
            save_checkpoint(path, self.state, self.step)
            print(f"[trainer] step {self.step} failed ({name}: {error}); emergency checkpoint "
                  f"-> {path}", flush=True)
        except Exception as e2:  # the state may be poisoned
            print(f"[trainer] step {self.step} failed ({name}) and the emergency checkpoint "
                  f"also failed ({e2})", flush=True)

    def validate(self):
        self._rank0(self._validate)

    def _validate(self):
        views = self.data.val_views()
        out_dir = os.path.join(self.save_dir, "save")
        self.system.save_validation_images(out_dir, self.state, views, self.step)
        print(f"[trainer] validation images -> {out_dir}", flush=True)

    def test(self):
        self._rank0(self._test)

    def _test(self):
        views = self.data.test_views()
        out_dir = os.path.join(self.save_dir, "save", f"it{self.step}-test")
        os.makedirs(out_dir, exist_ok=True)
        outs = self.system.render_views(self.state, views)
        for view, out in zip(views, outs):
            save_image_grid(os.path.join(out_dir, f"{view['index']}.png"), [out["comp_rgb"][0]])
        video = save_img_sequence(
            os.path.join(self.save_dir, "save", f"it{self.step}-test.mp4"),
            out_dir, r"(\d+)\.png", fps=30,
        )
        ply_path = os.path.join(self.save_dir, "save", "point_cloud.ply")
        self.system.geometry.save_ply(self.state.gauss, ply_path)
        print(f"[trainer] test renders -> {out_dir}; video={video}; ply={ply_path}", flush=True)

    def predict(self):
        """--predict: the SuGaR system's textured-mesh bake (OBJ + MTL + PNG
        under ``save/it<step>-predict/``) over the data's predict views, or
        its test views where it has none; a system without a predict
        surface runs the test renders.  The bake's stage times and counters
        are kept in ``predict_stats``.  Rank 0 alone bakes."""
        return self._rank0(self._predict)

    def _predict(self):
        if not hasattr(self.system, "predict_textured_mesh"):
            print("[trainer] system has no predict path; running test()", flush=True)
            return self._test()
        views = (self.data.predict_views() if hasattr(self.data, "predict_views")
                 else self.data.test_views())
        out_dir = os.path.join(self.save_dir, "save", f"it{self.step}-predict")
        os.makedirs(out_dir, exist_ok=True)
        out_path = os.path.join(out_dir, "textured_mesh.obj")
        self.predict_stats = {}
        result = self.system.predict_textured_mesh(self.state, views, out_path,
                                                   stats=self.predict_stats)
        print(f"[trainer] predict (textured mesh) -> {result}; "
              + ", ".join(f"{k} {v:.4g}" for k, v in self.predict_stats.items()
                          if not isinstance(v, list)), flush=True)
        return result

    def export(self):
        return self._rank0(self._export)

    def _export(self):
        exporter = find(self.system.cfg.exporter_type or "gaussian-mesh-exporter")(
            self.system.cfg.exporter, geometry=self.system.geometry
        )
        out_dir = os.path.join(self.save_dir, "save", "export")
        os.makedirs(out_dir, exist_ok=True)
        outputs = exporter(self.state.gauss, out_dir)
        print(f"[trainer] export -> {out_dir}: {outputs}", flush=True)
        return outputs

    def save_ckpt(self, name: str):
        self._rank0(lambda: self._save_ckpt(name))

    def _save_ckpt(self, name: str):
        path = os.path.join(self.save_dir, "ckpts", name)
        save_checkpoint(path, self.state, self.step)
        print(f"[trainer] checkpoint -> {path}", flush=True)
