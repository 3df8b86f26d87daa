"""The Experiment orchestrator: trial directory, summaries, seeding,
checkpoints, the training loop, prediction and validation.

The port of ``srgan_tpu.experiment.Experiment`` (``train``,
``training_loop``, ``load_models``/``save_models``,
``prepare_for_evaluation``, ``epoch_batch_iterators``, ``predict``,
``validation_summaries``, ``evaluate``, ``test``). The loop enqueues
steps without waiting for the device and synchronizes only on summary,
checkpoint and validation steps.

An experiment runs on the CUDA card unless it is given ``device="cpu"``
(or another device): without a card, :func:`default_device` raises
rather than train on the CPU unasked.

Data parallelism (``Settings.data_parallel_devices``; ``None`` means
every visible card, 1 on the CPU): an experiment built with
``data_parallel=dp`` is one rank. It holds its share of every global
batch, its step reduces the global objective (``train.py``), rank 0
alone writes summaries and checkpoints, every rank restores from the
file after a barrier, and ``predict`` and the evaluations split each
chunk over the ranks and gather it. ``train()`` called without a group
when the settings ask for more than one rank spawns the ranks
(``parallel/launch.py``), waits for them, and restores the trained
state from the last checkpoint into this process.

``dnn_only`` trains the DNN alone (``make_dnn_train_step``);
``profile_step_range`` traces steps ``[start, end)`` with
``torch.profiler`` into ``<trial>/profile/``, the program's spans
(``utils/trace.py``: ``loop.step``, ``loop.summary``, the crowd app's
``loop.chunk`` and input, and the step's phases) on its timeline;
``debug_nans`` turns on autograd's anomaly mode for ``train()`` and
checks every step's metrics.
``steps_per_dispatch`` > 1 runs K steps a dispatch in the crowd app alone
(``apps/crowd.py``); this class's loop refuses it, as JAX's does.

Tensor parallelism (``Settings.model_parallel_devices`` = M > 1): the
ranks form a grid of data × M ranks (``parallel/tp.py``), spawned as for
data parallelism; ``data_parallel_devices=None`` means
``max(1, cards // M)`` data ranks (1 on the CPU). Each rank holds its
blocks of the sharded parameters and Adam moments, the data ranks split
the batch and the model ranks of a data rank take the same share.
Checkpoints hold the full logical state (a trial restores on any grid
or on one process), and ``predict`` gathers the full model once a pass
and evaluates it replicated.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from srgan_tpu_torch import checkpoint, metrics
from srgan_tpu_torch.data.core import (ArrayDataset, cycling_batches,
                                       epoch_batches, prefetch_to_device,
                                       to_device)
from srgan_tpu_torch.parallel import tp
from srgan_tpu_torch.parallel.mesh import (DataParallel, barrier,
                                           data_axis_size, gather_rows,
                                           rank_devices)
from srgan_tpu_torch.settings import Settings
from srgan_tpu_torch.train import (ModelBundle, SRGANTrainState,
                                   default_labeled_loss_fn, init_train_state,
                                   make_dnn_train_step, make_gan_train_step,
                                   set_float32_precision)
from srgan_tpu_torch.utils import trace
from srgan_tpu_torch.utils.device import default_device
from srgan_tpu_torch.utils.seeding import generator_for, seed_all
from srgan_tpu_torch.utils.summary import SummaryWriter, make_trial_directory


def check_supported(settings: Settings) -> None:
    """Raise JAX's ``ValueError`` for a setting that JAX refuses before
    it builds the models (an unknown ``norm_impl`` raises as the models
    are built, as in JAX)."""
    model = settings.model_parallel_devices
    if model < 1:
        raise ValueError(
            f"model_parallel_devices must be >= 1, got {model}")


def check_batch_divides(batch_size: int, ranks: int) -> None:
    """JAX's refusal of a batch that does not split over the mesh."""
    if batch_size % ranks != 0:
        raise ValueError(
            f"batch_size {batch_size} must be divisible by the "
            f"data-parallel mesh size {ranks} (set "
            f"Settings.data_parallel_devices to restrict the mesh)")


class Experiment:
    """Orchestrates one SR-GAN trial on one device, or as one rank of a
    data-parallel group (``data_parallel``, whose device it runs on).

    Subclasses bind an application by implementing :meth:`dataset_setup`
    and :meth:`model_setup` (and, for an app with its own input pipeline
    or metrics, :meth:`epoch_batch_iterators`, :meth:`validation_summaries`
    and :meth:`evaluate`).
    """

    def __init__(self, settings: Settings,
                 device: Optional[torch.device | str] = None,
                 data_parallel: Optional[DataParallel] = None):
        self.settings = settings
        self.data_parallel = data_parallel
        if data_parallel is not None:
            wanted = settings.data_parallel_devices
            if wanted is not None and wanted != data_parallel.world_size:
                raise ValueError(
                    f"data_parallel_devices={wanted} but the group has "
                    f"{data_parallel.world_size} ranks")
            model = (1 if data_parallel.model is None
                     else data_parallel.model.size)
            if settings.model_parallel_devices != model:
                raise ValueError(
                    f"model_parallel_devices="
                    f"{settings.model_parallel_devices} but the group has "
                    f"{model} model ranks")
            device = data_parallel.device if device is None else device
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.trial_directory: Optional[str] = None
        # The trial directory of a run whose ranks were spawned: resolved
        # before the spawn, so that every rank names the same one.
        self.given_trial_directory: Optional[str] = None
        self.dnn_summary_writer: Optional[SummaryWriter] = None
        self.gan_summary_writer: Optional[SummaryWriter] = None
        self.labeled_dataset = None
        self.unlabeled_dataset = None
        self.validation_dataset = None
        self.test_dataset = None
        self.models: Optional[ModelBundle] = None
        self.state: Optional[SRGANTrainState] = None
        self._train_step = None
        self._rng: Optional[torch.Generator] = None
        # Offsets every host-side data RNG; nonzero only after a resume.
        self._start_step = 0
        # (host time, step) of the last summary, for the throughput.
        self._last_summary: Optional[tuple] = None
        # True inside prepare_for_evaluation: the input pipeline skips the
        # training splits, which evaluation never samples.
        self._evaluation_only = False
        self._checkpointer: Optional[checkpoint.AsyncStateCheckpointer] = \
            None

    # ------------------------------------------------------------ abstract
    def dataset_setup(self) -> None:
        raise NotImplementedError

    def model_setup(self) -> ModelBundle:
        """Return the models, on ``self.device``."""
        raise NotImplementedError

    def labeled_loss_fn(self):
        return default_labeled_loss_fn(self.settings)

    def latent_shape(self):
        return (self.settings.latent_dimension,)

    def epoch_batch_iterators(self):
        """Endless generator of per-epoch iterators of device-ready
        ``(labeled_x, labels, unlabeled_x)`` triples.

        Default: shuffled epochs of the labeled :class:`ArrayDataset`
        zipped with an endless unlabeled stream, drawn on the host from
        the JAX package's seed sequences (``[seed, 1, start]`` labeled,
        ``[seed, 2, start]`` unlabeled, ``start`` the restored step), so
        that a seed gives both packages the same batches and a resume
        starts a fresh order; prefetched to the device two batches
        ahead."""
        settings = self.settings
        data_rng = np.random.default_rng([settings.seed, 1,
                                          self._start_step])
        unlabeled_rng = np.random.default_rng([settings.seed, 2,
                                               self._start_step])
        unlabeled_iter = cycling_batches(self.unlabeled_dataset,
                                         settings.batch_size, unlabeled_rng)
        while True:
            batches = (
                (lab + (next(unlabeled_iter)[0],))
                for lab in epoch_batches(self.labeled_dataset,
                                         settings.batch_size, data_rng))
            yield (tuple(map(model_layout, batch)) for batch in
                   prefetch_to_device(batches, self.device,
                                      share=self.data_share))

    # ------------------------------------------------------------- plumbing
    @property
    def is_writer(self) -> bool:
        """Whether this process writes summaries and checkpoints: rank 0,
        or a run without a group."""
        return self.data_parallel is None or self.data_parallel.is_writer

    @property
    def data_share(self) -> slice:
        """This rank's rows of a global batch (all of them without a
        group)."""
        if self.data_parallel is None:
            return slice(None)
        return self.data_parallel.share(self.settings.batch_size)

    def prepare_summary_writers(self, prefix: str = "") -> None:
        """Two writers, so the DNN baseline and the SR-GAN compare
        directly; on a rank other than 0 they write nothing."""
        period = self.settings.summary_step_period
        self.dnn_summary_writer = SummaryWriter(
            os.path.join(self.trial_directory, f"{prefix}DNN"), period,
            enabled=self.is_writer)
        self.gan_summary_writer = SummaryWriter(
            os.path.join(self.trial_directory, f"{prefix}GAN"), period,
            enabled=self.is_writer)

    def prepare_train_step(self) -> None:
        dp = self.data_parallel
        check_batch_divides(self.settings.batch_size, data_axis_size(dp))
        if self.settings.dnn_only:
            # The supervised baseline alone: no G/D updates, labeled
            # batches only (the loop's _step).
            self._train_step = make_dnn_train_step(
                self.settings, labeled_loss_fn=self.labeled_loss_fn(),
                dp=dp)
        else:
            self._train_step = make_gan_train_step(
                self.settings, labeled_loss_fn=self.labeled_loss_fn(),
                latent_shape=self.latent_shape(), dp=dp)
        self._rng = generator_for(self.settings.seed, "train", self.device,
                                  start=self._start_step)

    def _restore(self, path: str) -> None:
        """Restore ``path`` into the state; under a group, after a
        barrier, so that a checkpoint rank 0 wrote is complete."""
        if self.data_parallel is not None:
            barrier(self.data_parallel)
        self.state = checkpoint.restore_state(self.state, path)

    def load_models(self) -> None:
        """Resume from ``settings.load_model_path`` (a trial directory or
        one of its ``checkpoints/step_<N>``)."""
        if self.settings.load_model_path:
            self._restore(self.settings.load_model_path)
            self._start_step = self.state.step

    def save_models(self) -> Optional[str]:
        """Enqueue a checkpoint of the state at its step: blocks only for
        the device→host copy; the file write overlaps the next steps and
        is joined in :meth:`close`. Rank 0 alone writes (its path is
        returned; other ranks return None); under tensor parallelism the
        model ranks of data rank 0 first gather the full state."""
        if not self.is_writer:
            dp = self.data_parallel
            if dp.model is not None and dp.rank == 0:
                checkpoint.gather_state(self.state)  # rank 0's gathers
            return None
        if self._checkpointer is None:
            self._checkpointer = checkpoint.AsyncStateCheckpointer()
        return self._checkpointer.save(self.state, self.trial_directory,
                                       self.state.step)

    def close(self) -> None:
        """Wait for pending checkpoint writes and close the summary
        writers."""
        try:
            if self._checkpointer is not None:
                self._checkpointer.close()
        finally:
            self._checkpointer = None
            for writer in (self.dnn_summary_writer, self.gan_summary_writer):
                if writer is not None:
                    writer.close()

    def prepare_for_evaluation(self, trial_directory: str
                               ) -> SRGANTrainState:
        """Everything needed to evaluate a saved trial without training:
        data, models and the restored state. ``trial_directory`` is the
        checkpoint source, as ``settings.load_model_path`` is; summaries
        go to its ``eval_GAN``/``eval_DNN``."""
        check_supported(self.settings)
        self.trial_directory = trial_directory
        self.prepare_summary_writers(prefix="eval_")
        self._restore_for_evaluation(trial_directory)
        return self.state

    def _restore_for_evaluation(self, path: str) -> None:
        """Data (training splits skipped), models and the state restored
        from ``path``."""
        set_float32_precision()
        self._evaluation_only = True
        self.dataset_setup()
        self.models = self.model_setup()
        self.state = init_train_state(self.settings, self.models,
                                      self.data_parallel)
        self.prepare_train_step()
        self._restore(path)

    def _make_trial_directory(self) -> str:
        """The given trial directory, else a new one; under a group rank
        0 makes it and the others take its name."""
        if self.given_trial_directory is not None:
            os.makedirs(self.given_trial_directory, exist_ok=True)
            return self.given_trial_directory
        dp = self.data_parallel
        name = [make_trial_directory(self.settings) if self.is_writer
                else None]
        if dp is not None:
            torch.distributed.broadcast_object_list(name, src=0,
                                                    group=dp.host_group)
        return name[0]

    # ------------------------------------------------------------- training
    def train(self) -> SRGANTrainState:
        """Full trial: trial directory, summaries, data, models, the
        restore of ``load_model_path``, the loop and a last checkpoint.

        Without a group, when the settings ask for more than one rank,
        the ranks are spawned to train and the trained state is restored
        here from the last checkpoint (see :meth:`_train_on_ranks`)."""
        settings = self.settings
        check_supported(settings)
        self.check_settings()
        if self.data_parallel is None:
            devices = rank_devices(settings.data_parallel_devices,
                                   device=self.device,
                                   model=settings.model_parallel_devices)
            if len(devices) > 1:
                return self._train_on_ranks(devices)
        set_float32_precision()
        # A prepare_for_evaluation() before must not leak its skipped
        # training splits into a training run.
        self._evaluation_only = False
        anomaly = (torch.is_anomaly_enabled(),
                   torch.is_anomaly_check_nan_enabled())
        if settings.debug_nans:
            torch.autograd.set_detect_anomaly(True)
        try:
            self.trial_directory = self._make_trial_directory()
            self.prepare_summary_writers()
            seed_all(settings.seed)
            self.dataset_setup()
            self.models = self.model_setup()
            self.state = init_train_state(settings, self.models,
                                          self.data_parallel)
            # Restore before the input pipeline is built: the step stream
            # and the patch draws start at the restored step.
            self.load_models()
            self.prepare_train_step()
            self.training_loop()
            self.save_models()
            return self.state
        finally:
            self.close()
            torch.autograd.set_detect_anomaly(*anomaly)

    def _train_on_ranks(self, devices) -> SRGANTrainState:
        """``train()`` on one spawned rank per device, under one trial
        directory made here; then the last checkpoint restored into this
        process (on its device, without a group) for ``evaluate`` and
        ``predict``."""
        from srgan_tpu_torch.parallel.launch import run_experiment
        model = self.settings.model_parallel_devices
        check_batch_divides(self.settings.batch_size, len(devices) // model)
        self.trial_directory = make_trial_directory(self.settings)
        run_experiment(type(self), self.settings, devices,
                       trial_directory=self.trial_directory, model=model)
        self._restore_for_evaluation(self.trial_directory)
        return self.state

    def check_settings(self) -> None:
        """Raise for settings this app refuses, before any rank is
        spawned (so that the caller of ``train()`` gets the error)."""

    def total_steps(self) -> int:
        """The step the loop trains to: ``epochs_to_run`` epochs, else
        ``steps_to_run``."""
        if self.settings.epochs_to_run is not None:
            return self.settings.epochs_to_run * self.steps_per_epoch()
        return self.settings.steps_to_run

    def training_loop(self) -> None:
        """Epochs of labeled batches, each step the fused GAN + DNN
        update; summaries every ``summary_step_period`` steps. One step a
        dispatch: ``steps_per_dispatch`` > 1 is refused, as JAX refuses
        it for an app whose loop takes one host batch a step."""
        settings = self.settings
        if settings.steps_per_dispatch > 1:
            raise ValueError(
                "steps_per_dispatch > 1 is only supported by apps with an "
                "on-device input pipeline (crowd HBM-resident path); this "
                "app's loop dispatches one step per host batch")
        step = self.state.step
        steps_per_epoch = self.steps_per_epoch()
        total_steps = self.total_steps()
        profile_range = settings.profile_step_range
        profiler = None
        self._last_summary = None
        epoch = step // steps_per_epoch
        epochs = self.epoch_batch_iterators()
        while step < total_steps:
            for labeled_x, labels, unlabeled_x in next(epochs):
                if (profile_range and profiler is None and self.is_writer
                        and step == profile_range[0]):
                    profiler = self._start_profiler()
                self.state, step_metrics = self._step(labeled_x, labels,
                                                      unlabeled_x)
                if settings.debug_nans:
                    check_finite(step_metrics, step)
                # [start, end): stop once the step numbered end-1 has run.
                if profiler is not None and step + 1 >= profile_range[1]:
                    self._stop_profiler(profiler)
                    profiler = None
                self.step_summaries(step, lambda: step_metrics)
                step += 1
                # step now equals state.step, which names the checkpoint.
                if (settings.save_step_period
                        and step % settings.save_step_period == 0):
                    self.save_models()
                if (settings.validation_step_period
                        and step % settings.validation_step_period == 0):
                    self.validation_summaries(
                        epoch=step // steps_per_epoch, step=step)
                if step >= total_steps:
                    break
            epoch += 1
            if not settings.validation_step_period:
                self.validation_summaries(epoch=epoch, step=step)
        if profiler is not None:  # the run ended inside the window
            self._stop_profiler(profiler)

    def step_summaries(self, step: int, step_metrics) -> None:
        """Point the writers at ``step``; on a summary step write the
        metrics that ``step_metrics()`` returns and the throughput since
        the last summary (reading the metrics synchronized with the
        device)."""
        self.gan_summary_writer.step = step
        self.dnn_summary_writer.step = step
        if not self.gan_summary_writer.is_summary_step():
            return
        with trace.span("loop.summary"):
            self.write_step_summaries(step_metrics())
        now = time.perf_counter()
        if self._last_summary is not None and step > self._last_summary[1]:
            last_time, last_step = self._last_summary
            steps_per_sec = (step - last_step) / (now - last_time)
            self.gan_summary_writer.add_scalar(
                "throughput/steps_per_second", steps_per_sec)
            self.gan_summary_writer.add_scalar(
                "throughput/examples_per_second",
                steps_per_sec * self.settings.batch_size)
        self._last_summary = (now, step)

    def _step(self, labeled_x, labels, unlabeled_x):
        with trace.span("loop.step"):
            if self.settings.dnn_only:
                return self._train_step(self.state, labeled_x, labels)
            return self._train_step(self.state, labeled_x, labels,
                                    unlabeled_x, self._rng)

    def _start_profiler(self) -> torch.profiler.profile:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler: torch.profiler.profile) -> None:
        """Stop ``profiler`` and write its Chrome trace to
        ``<trial>/profile/steps_<start>_<end>.json``, once the card has
        run what was enqueued. The program's spans are on while the
        profiler records (``utils/trace.py``): the trace shows them, and
        the copies they kept are dropped."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        start, end = self.settings.profile_step_range
        directory = os.path.join(self.trial_directory, "profile")
        os.makedirs(directory, exist_ok=True)
        profiler.export_chrome_trace(
            os.path.join(directory, f"steps_{start}_{end}.json"))
        trace.take()

    def steps_per_epoch(self) -> int:
        return max(1, len(self.labeled_dataset) // self.settings.batch_size)

    def write_step_summaries(self, step_metrics: Dict[str, torch.Tensor]
                             ) -> None:
        if not self.is_writer:
            return  # and no wait for the device
        # One device→host copy for the whole dict.
        names = list(step_metrics)
        values = torch.stack([step_metrics[k].float() for k in names]).cpu()
        for key, value in zip(names, values.tolist()):
            writer = (self.dnn_summary_writer if key.startswith("dnn")
                      else self.gan_summary_writer)
            writer.add_scalar(key, value)

    # ------------------------------------------------------------ validation
    def _resolve_use_dnn(self, use_dnn: Optional[bool]) -> bool:
        """None → the trial's trained model: the DNN for ``dnn_only``
        trials, else the SR-GAN discriminator."""
        return self.settings.dnn_only if use_dnn is None else use_dnn

    def predict(self, dataset: ArrayDataset,
                use_dnn: Optional[bool] = None) -> np.ndarray:
        """Predictions of D (or the DNN) on ``dataset``, float32 on the
        host, in chunks of ``batch_size`` (the last one shorter). Under a
        group each chunk, its tail padded with its last example to a
        multiple of the ranks, splits over the ranks and is gathered."""
        model = self.evaluation_model(use_dnn)
        bs = self.settings.batch_size
        dp = self.data_parallel
        outs = []
        with torch.inference_mode():
            for start in range(0, len(dataset), bs):
                chunk = dataset.examples[start:start + bs]
                k = len(chunk)
                pad = -k % data_axis_size(dp)
                if pad:
                    chunk = np.concatenate([chunk] + [chunk[-1:]] * pad)
                rows = slice(None) if dp is None else dp.share(len(chunk))
                out = model(model_layout(to_device(chunk[rows],
                                                   self.device)))[0].float()
                if dp is not None:
                    out = gather_rows(out, dp)
                outs.append(out[:k].cpu().numpy())
        return np.concatenate(outs, axis=0)

    def evaluation_model(self, use_dnn: Optional[bool]) -> torch.nn.Module:
        """D, or the DNN (``use_dnn``; ``None``: the trial's trained
        model), as one pass of evaluation runs it: under tensor
        parallelism an unsharded model of :meth:`model_setup` that loads
        the full parameters, gathered once (a collective of the model
        group)."""
        use_dnn = self._resolve_use_dnn(use_dnn)
        model = self.state.dnn if use_dnn else self.state.d
        if tp.module_axis(model) is None:
            return model
        bundle = self.model_setup()
        full = bundle.dnn if use_dnn else bundle.d
        full.load_state_dict(tp.full_state_dict(model))
        return full

    def validation_summaries(self, epoch: int, step: int) -> None:
        """MAE/RMSE/NVE of D and the DNN on the validation split; D is
        left out for ``dnn_only`` trials (its weights are untrained), and
        nothing is written for an absent or empty split."""
        if self.validation_dataset is None or \
                self.validation_dataset.labels is None or \
                len(self.validation_dataset) == 0:
            return
        labels = self.validation_dataset.labels
        for use_dnn, writer in ((False, self.gan_summary_writer),
                                (True, self.dnn_summary_writer)):
            if use_dnn and self.state.dnn is None:
                continue
            if not use_dnn and self.settings.dnn_only:
                continue
            preds = self.predict(self.validation_dataset, use_dnn=use_dnn)
            for name, value in regression_metrics(preds, labels).items():
                writer.add_scalar(f"validation/{name}", value, step)

    def evaluate(self, dataset: Optional[ArrayDataset] = None,
                 use_dnn: Optional[bool] = None) -> Dict[str, float]:
        """MAE/RMSE/NVE of ``dataset`` (default: the validation split).
        ``use_dnn=None`` evaluates the trial's trained model: the DNN for
        ``dnn_only`` trials, else D."""
        dataset = dataset if dataset is not None else self.validation_dataset
        if len(dataset) == 0:
            raise ValueError("cannot evaluate an empty dataset (a len-0 "
                             "split must not silently alias validation)")
        preds = self.predict(dataset, use_dnn=use_dnn)
        return regression_metrics(preds, dataset.labels)

    def test(self, use_dnn: Optional[bool] = None) -> Dict[str, float]:
        """Final held-out evaluation on the test split. Without one, the
        fallback to the validation split warns: a number labeled "test
        MAE" must not quietly be validation MAE."""
        if self.test_dataset is None:
            import warnings
            warnings.warn(
                "no test split configured; Experiment.test() is reporting "
                "VALIDATION metrics", stacklevel=2)
            return self.evaluate(self.validation_dataset, use_dnn=use_dnn)
        return self.evaluate(self.test_dataset, use_dnn=use_dnn)


def model_layout(t: torch.Tensor) -> torch.Tensor:
    """A batch as the models take it: a 4-D NHWC image batch becomes NCHW
    in ``channels_last`` memory (a view); anything else passes as is."""
    return t.permute(0, 3, 1, 2) if t.dim() == 4 else t


def regression_metrics(predictions, labels) -> Dict[str, float]:
    return {"MAE": float(metrics.mae(predictions, labels)),
            "RMSE": float(metrics.rmse(predictions, labels)),
            "NVE": float(metrics.nve(predictions, labels))}


def check_finite(step_metrics: Dict[str, torch.Tensor], step: int) -> None:
    """Raise ``FloatingPointError`` naming the first non-finite metric of
    a step (``debug_nans``; reading the metrics synchronizes)."""
    for name, value in step_metrics.items():
        if not math.isfinite(float(value)):
            raise FloatingPointError(
                f"step {step}: {name} is {float(value)} (debug_nans)")
