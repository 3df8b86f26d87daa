"""Crowd counting: SR-GAN over random patches of a crowd database.

The port of ``srgan_tpu.apps.crowd.CrowdExperiment``, with its three
input tiers:

* resident (the default): the whole training split lives on the device
  (images as uint8); every step draws random (index, offset, flip[,
  scale]) draws on the host, with the same NumPy stream as the JAX
  package, and the patch kernels (``srgan_tpu_torch/ops/patches.py``)
  cut the normalized image and label patches on the device: fixed P×P
  windows, or with ``crowd_rescale_factors`` windows of
  ``round(P · factor)`` resized to P×P;
* the window tier (``crowd_hbm_window``): a split larger than the window
  keeps a rotating window of it on the device (``data/window.py``), and
  the same kernels sample the window;
* the host tier (``crowd_host_pipeline``): the native C++ prefetcher
  (``io/native.py``) gathers uint8 crops on the host's threads; they are
  copied pinned and non-blocking and normalized on the device. Under
  data parallelism every rank draws the global batch's (index, offset,
  flip) from the resident tier's stream instead, and the native reader
  gathers the crops of its share alone.

Image and label patches share windows and flips, so augmentation stays
label-consistent. The label tensor is the density map ``[N, H, W, 1]``,
or with a kNN/iKNN target (``crowd_label_type``) ``[N, H, W, 2]``:
density for the counts, the aux map as the map head's target.

Evaluation cuts every validation image into a 50%-overlap grid of patches
(the patch kernel), runs D or the DNN on them, and reassembles the
overlap-averaged density canvas, whose sum is the image's count.
Validation writes MAE/RMSE/NVE/NAE for both models, G samples and
(input | truth | prediction) density triptychs.

The model is ``CROWD_MODELS[crowd_model]``: JointCNN, JointDCNN,
SpatialPyramidCNN or CSRNet. Its heads emit maps at 1/``OUTPUT_STRIDE``
of the patch's side (4, CSRNet 8): the labeled loss, the head biases,
the aux target and the evaluation grid read the stride of the model in
use, and a patch size that it does not divide is refused.

Under data parallelism every rank draws the global batch's patch
arguments from the same stream and cuts its share of the patches with
its own sampler launches. The training splits are replicated on every
rank, or with ``crowd_shard_dataset`` sharded: each rank holds its block
of the split cyclically padded to a multiple of the ranks (or its rows
of a sharded window), samples it with LOCAL indices, and never draws a
padded duplicate (per-position bounds, :func:`shard_local_counts`).
Grid evaluation splits each chunk of images over the ranks.

``steps_per_dispatch = K > 1`` (the resident and window tiers only, as in
JAX): the loop takes K steps a dispatch (:meth:`_chunked_training_loop`),
each chunk K (sample + step) iterations on K steps of the same
patch-argument stream and train generator that K single steps consume.
On the card a chunk is one CUDA graph replay (``utils/cuda_graph.py``);
on the CPU it is the K steps in a loop. The G update's period is decided
on the host, so a chunk's graph is keyed by the phase ``step % period``
at which it starts (one graph a phase that a chunk meets; one in all for
the default period of 1).
"""

from __future__ import annotations

import functools
import itertools
import os
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from srgan_tpu_torch import metrics
from srgan_tpu_torch.apps.common import write_generated_sample_grid
from srgan_tpu_torch.data.core import prefetch_to_device
from srgan_tpu_torch.data.crowd import CrowdDatabase, synthetic_crowd_database
from srgan_tpu_torch.data.window import HBMWindow
from srgan_tpu_torch.experiment import Experiment, check_finite
from srgan_tpu_torch.models.crowd import (CROWD_MODELS, CrowdDCGenerator,
                                          SpatialPyramidCNN)
from srgan_tpu_torch.ops.patches import (extract_patches,
                                         extract_rescaled_patches)
from srgan_tpu_torch.parallel.mesh import (all_ranks_agree, data_axis_size,
                                           gather_rows)
from srgan_tpu_torch.train import ModelBundle
from srgan_tpu_torch.utils.cuda_graph import TrainChunk
from srgan_tpu_torch.utils.seeding import generator_for
from srgan_tpu_torch.utils.trace import span


def crowd_model_class(name: str):
    """``CROWD_MODELS[name]``, or JAX's error for an unknown name."""
    try:
        return CROWD_MODELS[name]
    except KeyError:
        raise ValueError(f"unknown crowd_model {name!r}; choose from "
                         f"{sorted(CROWD_MODELS)}") from None


def shard_local_counts(n: int, num_shards: int) -> np.ndarray:
    """True (un-padded) example count per contiguous shard of a length-n
    array cyclically padded to a multiple of ``num_shards``.

    Shard s holds rows [s·per, (s+1)·per); rows ≥ n are cyclic-pad
    duplicates, which sampling local indices below the true count keeps
    out of the draws. A shard that is all padding (n < num_shards) keeps
    bound 1: its row 0 is a duplicate, and the only row to draw."""
    per = -(-n // num_shards)
    counts = n - np.arange(num_shards, dtype=np.int64) * per
    return np.maximum(np.minimum(counts, per), 1).astype(np.int64)


def shard_rows(n: int, num_shards: int, shard: int) -> np.ndarray:
    """Source rows of shard ``shard`` of a length-n array cyclically
    padded to a multiple of ``num_shards``."""
    per = -(-n // num_shards)
    return np.arange(shard * per, (shard + 1) * per) % n


def sum_pool(x: torch.Tensor, factor: int) -> torch.Tensor:
    """[B, H, W] → [B, H/f, W/f] by window summation (mass-preserving)."""
    b, h, w = x.shape
    return x.reshape(b, h // factor, factor,
                     w // factor, factor).sum(dim=(2, 4))


class InputAffine(nn.Module):
    """``model(x * a + b)`` with per-channel (a, b): the 'meanstd' image
    normalization, applied inside D and the DNN so that every input
    stream, the fake one included, shares it."""

    def __init__(self, model: nn.Module, a: np.ndarray, b: np.ndarray):
        super().__init__()
        self.model = model
        self.register_buffer("a", torch.as_tensor(a).view(1, -1, 1, 1))
        self.register_buffer("b", torch.as_tensor(b).view(1, -1, 1, 1))

    def forward(self, x: torch.Tensor):
        return self.model(x * self.a + self.b)


class CrowdExperiment(Experiment):
    """SR-GAN crowd counting with the on-device patch pipeline."""

    def __init__(self, settings, device=None, data_parallel=None):
        super().__init__(settings, device, data_parallel)
        self.labeled_db: Optional[CrowdDatabase] = None
        self.unlabeled_db: Optional[CrowdDatabase] = None
        self.validation_db: Optional[CrowdDatabase] = None
        self.test_db: Optional[CrowdDatabase] = None
        self._device_data = None
        self._labeled_index_bound = 0
        self._unlabeled_index_bound = 0
        # Sharded splits: each shard's true example count.
        self._labeled_local_counts: Optional[np.ndarray] = None
        self._unlabeled_local_counts: Optional[np.ndarray] = None
        self._windows: List[HBMWindow] = []
        self._host_io: list = []  # the host tier's readers and prefetchers
        # Grid evaluators by _grid_fn_key, built at first use.
        self._grid_count_fns: Dict[tuple, object] = {}
        # steps_per_dispatch > 1: chunk(args [K, A], key) -> metrics [K].
        self._train_chunk = None

    # ------------------------------------------------------------ datasets
    def _load_databases(self) -> Tuple[CrowdDatabase, CrowdDatabase,
                                       CrowdDatabase,
                                       Optional[CrowdDatabase]]:
        """(labeled, unlabeled, validation, test-or-None)."""
        settings = self.settings
        if settings.crowd_database_path:
            root = settings.crowd_database_path
            test_path = os.path.join(root, "test.npz")
            return (CrowdDatabase.load(os.path.join(root, "labeled.npz")),
                    CrowdDatabase.load(os.path.join(root, "unlabeled.npz")),
                    CrowdDatabase.load(os.path.join(root, "validation.npz")),
                    CrowdDatabase.load(test_path)
                    if os.path.exists(test_path) else None)
        # Hermetic fallback: procedural data (no real database on disk).
        h, w = settings.crowd_image_height, settings.crowd_image_width
        make = functools.partial(
            synthetic_crowd_database, height=h, width=w,
            max_heads=settings.crowd_synthetic_max_heads,
            sigma=settings.crowd_sigma,
            label_type=settings.crowd_label_type)
        return (make(settings.labeled_dataset_size, seed=settings.seed),
                make(settings.unlabeled_dataset_size,
                     seed=settings.seed + 1),
                make(settings.validation_dataset_size,
                     seed=settings.seed + 2),
                make(settings.test_dataset_size, seed=settings.seed + 3))

    @property
    def output_stride(self) -> int:
        """The side of the patch over that of the model's maps."""
        return crowd_model_class(self.settings.crowd_model).OUTPUT_STRIDE

    @property
    def uses_aux_target(self) -> bool:
        return self.settings.crowd_label_type != "density"

    def dataset_setup(self) -> None:
        label_type = self.settings.crowd_label_type
        if label_type not in ("density", "knn", "iknn"):
            raise ValueError(f"unknown crowd_label_type {label_type!r}; "
                             f"choose density, knn or iknn")
        (self.labeled_db, self.unlabeled_db, self.validation_db,
         self.test_db) = self._load_databases()
        if self.uses_aux_target:
            if self.labeled_db.aux_maps is None:
                raise ValueError(
                    f"crowd_label_type={label_type!r} needs a database "
                    f"preprocessed with the matching --label-type "
                    f"(aux_maps missing)")
            if self.labeled_db.label_type != label_type:
                raise ValueError(
                    f"crowd_label_type={label_type!r} but the database "
                    f"was preprocessed with "
                    f"--label-type {self.labeled_db.label_type!r}")
        self.labeled_dataset = self.labeled_db
        self.unlabeled_dataset = self.unlabeled_db
        # test() and the command line dispatch on these; evaluate() takes
        # CrowdDatabases.
        self.validation_dataset = self.validation_db
        self.test_dataset = self.test_db

    @property
    def _label_dtype(self) -> torch.dtype:
        """Device dtype of the training label maps; the patch kernel
        upcasts to float32."""
        name = self.settings.crowd_label_dtype
        if name not in ("float32", "bfloat16"):
            raise ValueError(f"unknown crowd_label_dtype {name!r}; "
                             f"choose float32 or bfloat16")
        return getattr(torch, name)

    def _stacked_labels(self, rows=slice(None)) -> np.ndarray:
        """Label tensor: [N,H,W,1] density, or [N,H,W,2] (density, aux);
        of ``rows`` alone when given."""
        dens = self.labeled_db.density_maps[rows]
        if self.uses_aux_target:
            return np.stack([dens, self.labeled_db.aux_maps[rows]], axis=-1)
        return dens[..., None]

    @property
    def _shard_dataset(self) -> bool:
        return (self.settings.crowd_shard_dataset
                and data_axis_size(self.data_parallel) > 1
                and not self.settings.crowd_host_pipeline)

    def _check_hbm_budget(self) -> None:
        """Warn, before an opaque device OOM, when the training splits
        take more than 60% of the device's memory, naming the escape
        hatches in order of cost. The limit is the card's memory
        (``total_memory``); on another device, ``device_hbm_gb``."""
        # Sizes computed arithmetically: the stacked labels would be a
        # full host copy on exactly the multi-GB path this serves.
        label_itemsize = self._label_dtype.itemsize
        dens = self.labeled_db.density_maps
        label_bytes = (dens.nbytes // dens.itemsize) * label_itemsize
        if self.uses_aux_target:
            aux = self.labeled_db.aux_maps
            label_bytes += (aux.nbytes // aux.itemsize) * label_itemsize
        # Window tier: only each split's window is resident, plus the one
        # staged slice in flight (window / slices rows).
        lab_window = self._window_size_for(self.labeled_db)
        unl_window = self._window_size_for(self.unlabeled_db)
        slices = self.settings.crowd_window_slices
        resident = lambda win: win * (1.0 + 1.0 / slices)
        lab_frac = ((resident(lab_window) / len(self.labeled_db))
                    if lab_window else 1.0)
        unl_frac = ((resident(unl_window) / len(self.unlabeled_db))
                    if unl_window else 1.0)
        train_arrays = [int(self.labeled_db.images.nbytes * lab_frac),
                        int(label_bytes * lab_frac),
                        int(self.unlabeled_db.images.nbytes * unl_frac)]
        if self._shard_dataset:
            # One device's shard of each array, with the cyclic pad to a
            # multiple of the ranks (what _upload_databases places).
            d = data_axis_size(self.data_parallel)

            def shard_bytes(total, n):
                return -(-n // d) * (total // max(n, 1))

            lab_n = lab_window or len(self.labeled_db)
            train_arrays = [
                shard_bytes(train_arrays[0], lab_n),
                shard_bytes(train_arrays[1], lab_n),
                shard_bytes(train_arrays[2],
                            unl_window or len(self.unlabeled_db))]
        # The validation split is on every device, and so are this rank's
        # parameters and Adam moments (its shards under tensor
        # parallelism).
        db_bytes = (sum(train_arrays) + self.validation_db.images.nbytes
                    + self._state_bytes())
        if self.device.type == "cuda":
            limit = torch.cuda.get_device_properties(
                self.device).total_memory
            assumed = ""
        else:
            limit = int(self.settings.device_hbm_gb * 1e9)
            assumed = (f" (assumed capacity device_hbm_gb="
                       f"{self.settings.device_hbm_gb:g} GB on the "
                       f"{self.device.type} device)")
        if db_bytes > 0.6 * limit:
            hatches = []
            if self._label_dtype == torch.float32:
                hatches.append("crowd_label_dtype='bfloat16' (halves "
                               "the label maps, full speed)")
            if not self.settings.crowd_hbm_window:
                hatches.append("crowd_hbm_window=<N> (rotating resident "
                               "window: full-speed sampling, dataset "
                               "streams through device memory "
                               "asynchronously)")
            if not self._shard_dataset:
                hatches.append("crowd_shard_dataset=True (capacity "
                               "scales with the number of devices)")
            hatches.append("crowd_host_pipeline=True (native host "
                           "streaming)")
            warnings.warn(
                f"crowd database needs {db_bytes / 1e9:.1f} GB of the "
                f"{limit / 1e9:.1f} GB of device memory{assumed}; "
                f"consider " + ", ".join(hatches), stacklevel=3)

    def _state_bytes(self) -> int:
        """Bytes of this rank's parameters and their two Adam moments."""
        if self.state is None:
            return 0
        return sum(3 * p.numel() * p.element_size()
                   for opt in (self.state.d_opt, self.state.g_opt,
                               self.state.dnn_opt) if opt is not None
                   for p in opt.params)

    def _window_size_for(self, db: CrowdDatabase) -> int:
        """Resident window size for a training split: 0 = fully resident
        (window tier off, or the split already fits)."""
        win = self.settings.crowd_hbm_window
        if win and self.settings.crowd_window_slices < 1:
            raise ValueError(
                f"crowd_window_slices="
                f"{self.settings.crowd_window_slices} must be a positive "
                f"slice count when crowd_hbm_window is set")
        if win and len(db) > win:
            return win
        return 0

    def _labels_source(self, db: CrowdDatabase):
        """Per-slice stacked-label assembly for the window tier, never the
        full [N,H,W,C] stack; the bfloat16 cast goes through torch."""
        aux = self.uses_aux_target
        dtype = self._label_dtype

        def source(ids: np.ndarray) -> torch.Tensor:
            dens = db.density_maps[ids]
            stacked = (np.stack([dens, db.aux_maps[ids]], axis=-1) if aux
                       else dens[..., None])
            return torch.from_numpy(
                stacked.astype(np.float32, copy=False)).to(dtype)

        return source

    def _build_window(self, names, sources, num_examples: int,
                      window: int, stream: int) -> HBMWindow:
        """A window on this device: the whole window on every rank, or
        this rank's shard of it under ``crowd_shard_dataset``; under data
        parallelism its opportunistic refreshes agreed by every rank."""
        settings = self.settings
        dp = self.data_parallel
        sharded = self._shard_dataset
        period = settings.crowd_window_refresh_period
        if (period > 0 and settings.steps_per_dispatch > 1
                and period % settings.steps_per_dispatch):
            raise ValueError(
                f"crowd_window_refresh_period={period} must be a multiple "
                f"of steps_per_dispatch={settings.steps_per_dispatch} "
                f"(refreshes happen at chunk boundaries)")
        # [seed, stream, start] as the other data streams: distinct
        # streams for the labeled and unlabeled windows (equal-sized
        # splits would rotate in lockstep), a fresh order on resume.
        return HBMWindow(
            names, sources, num_examples, window,
            settings.crowd_window_slices,
            seed=[settings.seed, stream, self._start_step],
            device=self.device,
            refresh_period=settings.crowd_window_refresh_period,
            num_shards=data_axis_size(dp) if sharded else 1,
            shard=dp.rank if sharded else 0,
            agree=(None if dp is None else
                   functools.partial(all_ranks_agree, dp=dp)))

    def _refresh_windows(self, step: int) -> None:
        for w in self._windows:
            if w.maybe_refresh(step):
                self._device_data.update(w.arrays)

    def _close_inputs(self) -> None:
        """Stop the window stagers and the host tier's prefetchers (the
        windows stay readable: ``resident_ids``, ``refresh_count``)."""
        for w in self._windows:
            w.close()
        for io in self._host_io:
            io.close()

    def close(self) -> None:
        try:
            self._close_inputs()
        finally:
            self._train_chunk = None  # its graphs' memory
            super().close()

    def _upload_databases(self) -> None:
        """Place the splits on the device once: images as uint8 (raw
        0..255), labels [N, H, W, 1|2] in ``_label_dtype``, and the
        validation images for grid evaluation.

        An evaluation-only run places the validation images alone; the
        host tier keeps the training splits on the host; the window tier
        keeps a rotating window of any split larger than
        ``crowd_hbm_window`` (the samplers' index bound is then the
        window).

        Under ``crowd_shard_dataset`` each rank places its block of each
        split cyclically padded to a multiple of the ranks (or its shard
        of the window) and samples it with local indices below its
        block's true count."""
        settings = self.settings
        device = self.device
        self._close_inputs()  # a rebuild must not leak stager threads
        self._windows, self._host_io = [], []
        self._device_data = {"validation_images": torch.from_numpy(
            self.validation_db.images).to(device)}
        if settings.crowd_host_pipeline:
            if settings.crowd_hbm_window:
                raise ValueError(
                    "crowd_hbm_window and crowd_host_pipeline are "
                    "mutually exclusive tiers; the window tier replaces "
                    "host streaming for larger-than-memory databases")
            _ = self._label_dtype  # validated before any export
            self._labeled_index_bound = len(self.labeled_db)
            self._unlabeled_index_bound = len(self.unlabeled_db)
            return
        if self._evaluation_only:
            self._labeled_index_bound = len(self.labeled_db)
            self._unlabeled_index_bound = len(self.unlabeled_db)
            return
        self._check_hbm_budget()
        lab_window = self._window_size_for(self.labeled_db)
        unl_window = self._window_size_for(self.unlabeled_db)
        self._labeled_local_counts = self._unlabeled_local_counts = None
        if self._shard_dataset:
            d = data_axis_size(self.data_parallel)
            rank = self.data_parallel.rank

            def counts(window, n):
                # A sharded window's blocks are always full.
                return (np.full(d, window // d, np.int64) if window
                        else shard_local_counts(n, d))

            self._labeled_local_counts = counts(lab_window,
                                                len(self.labeled_db))
            self._unlabeled_local_counts = counts(unl_window,
                                                  len(self.unlabeled_db))
            self._labeled_index_bound = int(self._labeled_local_counts[0])
            self._unlabeled_index_bound = int(
                self._unlabeled_local_counts[0])
            lab_rows = shard_rows(len(self.labeled_db), d, rank)
            unl_rows = shard_rows(len(self.unlabeled_db), d, rank)
        else:
            self._labeled_index_bound = lab_window or len(self.labeled_db)
            self._unlabeled_index_bound = (unl_window
                                           or len(self.unlabeled_db))
            lab_rows = unl_rows = slice(None)
        if lab_window:
            window = self._build_window(
                ["labeled_images", "labeled_density"],
                [lambda ids, a=self.labeled_db.images:
                 torch.from_numpy(a[ids]),
                 self._labels_source(self.labeled_db)],
                len(self.labeled_db), lab_window, stream=7)
            self._windows.append(window)
            self._device_data.update(window.arrays)
        else:
            labels = torch.from_numpy(self._stacked_labels(lab_rows))
            self._device_data.update({
                "labeled_images": torch.from_numpy(
                    self.labeled_db.images[lab_rows]).to(device),
                "labeled_density": labels.to(device).to(self._label_dtype),
            })
        if unl_window:
            window = self._build_window(
                ["unlabeled_images"],
                [lambda ids, a=self.unlabeled_db.images:
                 torch.from_numpy(a[ids])],
                len(self.unlabeled_db), unl_window, stream=8)
            self._windows.append(window)
            self._device_data.update(window.arrays)
        else:
            self._device_data["unlabeled_images"] = torch.from_numpy(
                self.unlabeled_db.images[unl_rows]).to(device)

    def _prepare_host_pipeline(self) -> None:
        """Export the training splits as .npy and open the native readers
        (``csrc/srgan_io.cc``); with one rank, start the prefetchers
        (several ranks gather their shares of the global draws instead,
        :meth:`_host_epoch_iterators`, and so do the model ranks of a
        grid: a prefetcher's threads deliver its batches in no fixed
        order, and every model rank must take the same one).

        The exports live in a ``native_cache`` beside the database
        (reused across runs: the host tier exists for large splits), or
        for synthetic data in a temporary directory removed at exit. The
        label export is keyed by label type."""
        from srgan_tpu_torch.io.native import (NativeDatasetReader,
                                               NativePrefetcher)

        warnings.warn(
            "crowd_host_pipeline streams batches from the host: the "
            "native gather runs on the host's threads and the step waits "
            "for it, well below the device-resident path's rate. Prefer "
            "the resident path or crowd_hbm_window (a rotating window "
            "sampled at full speed); use the host tier only for "
            "databases that even a window cannot serve.", stacklevel=2)
        settings = self.settings
        if settings.crowd_database_path:
            cache = os.path.join(settings.crowd_database_path,
                                 "native_cache")
            os.makedirs(cache, exist_ok=True)
        else:
            import atexit
            import shutil
            import tempfile
            cache = tempfile.mkdtemp(prefix="srgan_native_")
            atexit.register(shutil.rmtree, cache, ignore_errors=True)
        paths = {
            "labeled": os.path.join(cache, "labeled.npy"),
            "density": os.path.join(
                cache, f"labels_{settings.crowd_label_type}.npy"),
            "unlabeled": os.path.join(cache, "unlabeled.npy"),
        }

        def export(path, make_array):
            if not os.path.exists(path):  # else cached by an earlier run
                np.save(path, make_array())

        export(paths["labeled"], lambda: self.labeled_db.images)
        export(paths["density"], lambda: self._stacked_labels().astype(
            np.float32, copy=False))
        export(paths["unlabeled"], lambda: self.unlabeled_db.images)
        self._labeled_reader = NativeDatasetReader(paths["labeled"])
        self._density_reader = NativeDatasetReader(paths["density"])
        self._unlabeled_reader = NativeDatasetReader(paths["unlabeled"])
        self._host_io = [self._labeled_reader, self._density_reader,
                         self._unlabeled_reader]
        if self._host_draws_shared:
            return
        # 2·start keeps the two streams' seeds disjoint (11 + 2k odd,
        # 12 + 2k even) and gives a resumed run fresh orders. Image crops
        # travel as raw uint8 and are normalized on the device.
        threads = max(1, settings.number_of_data_workers)
        self._labeled_prefetcher = NativePrefetcher(
            self._labeled_reader, settings.batch_size, settings.image_patch_size,
            output_dtype="uint8", num_threads=threads,
            seed=settings.seed + 11 + 2 * self._start_step)
        self._unlabeled_prefetcher = NativePrefetcher(
            self._unlabeled_reader, settings.batch_size,
            settings.image_patch_size, output_dtype="uint8",
            num_threads=threads,
            seed=settings.seed + 12 + 2 * self._start_step)
        # Prefetchers first: their threads read the readers' maps.
        self._host_io[:0] = [self._labeled_prefetcher,
                             self._unlabeled_prefetcher]

    @property
    def _host_draws_shared(self) -> bool:
        """Whether the host tier's ranks gather crops of the global draws
        (several data ranks, or a model axis) instead of prefetching."""
        dp = self.data_parallel
        return data_axis_size(dp) > 1 or (dp is not None
                                          and dp.model is not None)

    def _wrap_host_train_step(self) -> None:
        """The host tier's step: the uint8 crops are normalized and the
        float32 labels rounded to ``crowd_label_dtype`` on the device,
        then the step runs as on the resident path."""
        raw = self._train_step
        label_dtype = self._label_dtype

        def norm(u8):
            return (u8.float() * (2.0 / 255.0) - 1.0).permute(0, 3, 1, 2)

        def labels_of(labels):
            return labels.to(label_dtype).float()

        if self.settings.dnn_only:
            def host_step(state, patches_u8, labels):
                return raw(state, norm(patches_u8), labels_of(labels))
        else:
            def host_step(state, patches_u8, labels, upatches_u8,
                          *args, **kwargs):
                return raw(state, norm(patches_u8), labels_of(labels),
                           norm(upatches_u8), *args, **kwargs)

        self._train_step = host_step

    # -------------------------------------------------------------- models
    def model_setup(self) -> ModelBundle:
        settings = self.settings
        dtype = getattr(torch, settings.compute_dtype)
        w = settings.model_base_width
        model_cls = crowd_model_class(settings.crowd_model)
        if model_cls is SpatialPyramidCNN:  # its levels follow the map
            model_cls = functools.partial(
                model_cls, image_size=settings.image_patch_size)
        # Dataset-mean per-cell head biases: with zero-init kernels the
        # step-0 prediction is the dataset-mean map and count. The density
        # head regresses sum_pool(density, f) for the output stride f,
        # i.e. f² × the mean pixel, or in aux mode the mean-pooled aux
        # map, i.e. its mean.
        if settings.zero_init_heads:
            cell = self.output_stride ** 2
            loaded = self.labeled_db is not None
            mean_px = (float(np.mean(self.labeled_db.density_maps))
                       if loaded else 0.0)
            density_bias = (float(np.mean(self.labeled_db.aux_maps))
                            if self.uses_aux_target and loaded
                            else mean_px * cell)
            head_init = dict(zero_init_heads=True,
                             density_head_bias=density_bias,
                             count_head_bias=mean_px * cell)
        else:
            head_init = dict(zero_init_heads=False)
        # Init draws on the host, so a seed gives the same weights on
        # every device.
        rng = generator_for(settings.seed, "init")
        impl = settings.norm_impl
        d = model_cls(w, dtype=dtype, norm_impl=impl, rng=rng, **head_init)
        g = CrowdDCGenerator(image_size=settings.image_patch_size,
                             base_width=w,
                             latent_dimension=settings.latent_dimension,
                             dtype=dtype, norm_impl=impl, rng=rng)
        dnn = model_cls(w, dtype=dtype, norm_impl=impl,
                        use_norm=settings.dnn_use_norm, rng=rng, **head_init)
        transform = self._input_normalization_transform()
        if transform is not None:
            d, dnn = InputAffine(d, *transform), InputAffine(dnn, *transform)
        place = functools.partial(nn.Module.to, device=self.device,
                                  memory_format=torch.channels_last)
        return ModelBundle(d=place(d), g=place(g), dnn=place(dnn))

    def _input_normalization_transform(self):
        """Per-channel affine ``(a, b)`` for D/DNN inputs, or None for the
        default '[-1,1]' space. With pixels p in [0,1] and x = 2p − 1,
        ``(p − m)/s = x · (0.5/s) + (0.5 − m)/s``."""
        mode = self.settings.image_normalization
        if mode == "[-1,1]":
            return None
        if mode != "meanstd":
            raise ValueError(
                f"unknown image_normalization {mode!r}; choose "
                f"'[-1,1]' or 'meanstd'")
        if self.labeled_db is None:
            raise ValueError(
                "image_normalization='meanstd' needs the dataset loaded "
                "before model_setup (run dataset_setup first)")
        mean, std = self.labeled_db.image_statistics()
        return ((0.5 / std).astype(np.float32),
                ((0.5 - mean) / std).astype(np.float32))

    # --------------------------------------------------------------- loss
    def labeled_loss_fn(self):
        """Joint density-map + count loss. predictions: (density_map,
        count_map), each [B, P/f, P/f] for the model's output stride f;
        labels: density patches [B, P, P],
        or [B, P, P, 2] (density, aux) with a kNN/iKNN target, whose map
        head regresses the mean-pooled aux map (value-like, not
        mass-like) while the counts come from the density channel."""
        settings = self.settings
        aux_mode = self.uses_aux_target
        f = self.output_stride

        def loss_fn(predictions, labels):
            density_map, count_map = predictions
            if aux_mode:
                density_ch = labels[..., 0]
                map_target = sum_pool(labels[..., 1], f) / f ** 2
            else:
                density_ch = labels
                map_target = sum_pool(labels, f)
            map_loss = (density_map - map_target).square().mean()
            true_count = density_ch.sum(dim=(1, 2))
            pred_count = count_map.sum(dim=(1, 2))
            count_loss = (pred_count - true_count).square().mean()
            return (map_loss * settings.density_loss_multiplier
                    + count_loss * settings.count_loss_multiplier)

        return loss_fn

    # ------------------------------------------------------ batch pipeline
    @property
    def _rescale_windows(self) -> Tuple[int, ...]:
        """Source-window sides of the random rescale (empty: off)."""
        p = self.settings.image_patch_size
        return tuple(int(round(p * f))
                     for f in self.settings.crowd_rescale_factors)

    def prepare_train_step(self) -> None:
        super().prepare_train_step()
        self._upload_databases()
        if self.settings.crowd_host_pipeline and not self._evaluation_only:
            self._prepare_host_pipeline()
            self._wrap_host_train_step()
        p = self.settings.image_patch_size
        windows = self._rescale_windows
        if windows:
            if self.uses_aux_target:
                raise ValueError(
                    "crowd_rescale_factors requires crowd_label_type="
                    "'density' — kNN/iKNN distance targets are not "
                    "scale-covariant under patch resize")
            if self.settings.crowd_host_pipeline:
                raise ValueError(
                    "crowd_rescale_factors is not supported with "
                    "crowd_host_pipeline (the native prefetcher samples "
                    "fixed-size patches); use the device-resident path")
            if min(windows) < 1:
                raise ValueError(
                    f"crowd_rescale_factors produce degenerate windows "
                    f"{windows} at patch size {p}")
            limit = min(min(self.labeled_db.image_size),
                        min(self.unlabeled_db.image_size))
            if max(windows) > limit:
                raise ValueError(
                    f"largest rescale window {max(windows)} "
                    f"(patch {p} x factor "
                    f"{max(self.settings.crowd_rescale_factors)}) "
                    f"exceeds the smallest image dimension {limit}; "
                    f"reduce the factors or use larger images")
        self._train_chunk = None
        if self.settings.steps_per_dispatch > 1 and not self._evaluation_only:
            self._prepare_train_chunk()

    @staticmethod
    def _flat_args(arrays) -> np.ndarray:
        """A step's patch arguments as one int32 row."""
        return np.concatenate([a.ravel() for a in arrays]).astype(np.int32)

    @staticmethod
    def _split_args(flat: torch.Tensor, shapes) -> List[torch.Tensor]:
        """The arrays of shapes ``shapes`` that ``flat`` holds, as views."""
        parts = torch.split(flat, [int(np.prod(s)) for s in shapes])
        return [t.view(s) for t, s in zip(parts, shapes)]

    def _to_device(self, *arrays: np.ndarray):
        """One host→device copy for all of a step's small int32 arrays,
        from pinned memory so that it does not wait for the device."""
        with span("input.copy"):
            flat = torch.from_numpy(self._flat_args(arrays))
            if self.device.type == "cuda":
                flat = flat.pin_memory().to(self.device, non_blocking=True)
            return self._split_args(flat, [a.shape for a in arrays])

    def _sample_batch(self, labeled_images, labeled_density,
                      unlabeled_images, *args: np.ndarray):
        """Three patch-kernel calls on a step's host draws (the 8 arrays
        of :meth:`_patch_args_stream`): see :meth:`_sample_patches`."""
        return self._sample_patches(labeled_images, labeled_density,
                                    unlabeled_images, *self._to_device(*args))

    def _sample_patches(self, labeled_images, labeled_density,
                        unlabeled_images, idx, offs, flips, sidx, uidx,
                        uoffs, uflips, usidx):
        """Three patch-kernel calls on the arguments on the device:
        labeled images and their labels (same windows; with rescale,
        mass-preserving), and unlabeled images. Returns NCHW image patches
        (channels_last memory) and [B, P, P] density labels, or
        [B, P, P, 2] with an aux target."""
        p = self.settings.image_patch_size
        windows = self._rescale_windows
        image = dict(patch_size=p, scale=2.0 / 255.0, shift=-1.0)
        with span("input.sample"):
            if windows:
                patches = extract_rescaled_patches(
                    labeled_images, offs, flips, sidx, window_sizes=windows,
                    indices=idx, **image)
                # The density mass of the source window survives the
                # resize (count targets integrate the patch).
                labels = extract_rescaled_patches(
                    labeled_density, offs, flips, sidx, patch_size=p,
                    window_sizes=windows, preserve_mass=True, indices=idx)
                upatches = extract_rescaled_patches(
                    unlabeled_images, uoffs, uflips, usidx,
                    window_sizes=windows, indices=uidx, **image)
            else:
                patches = extract_patches(labeled_images, offs, flips,
                                          indices=idx, **image)
                labels = extract_patches(labeled_density, offs, flips,
                                         patch_size=p, indices=idx)
                upatches = extract_patches(unlabeled_images, uoffs, uflips,
                                           indices=uidx, **image)
        if labels.shape[-1] == 1:
            labels = labels[..., 0]
        return (patches.permute(0, 3, 1, 2), labels,
                upatches.permute(0, 3, 1, 2))

    def _random_patch_args(self, rng: np.random.Generator, n_images: int,
                           image_hw: Tuple[int, int], batch: int):
        """Sample ``(index, offset, flip, scale_idx)`` per example, with
        the JAX package's draws: the scale index only when the rescale is
        on, and offsets that keep each example's own window inside its
        image."""
        h, w = image_hw
        windows = self._rescale_windows
        idx = rng.integers(0, n_images, batch).astype(np.int32)
        if windows:
            sidx = rng.integers(0, len(windows), batch).astype(np.int32)
            win = np.asarray(windows, np.int64)[sidx]
        else:
            sidx = np.zeros(batch, np.int32)
            win = self.settings.image_patch_size
        offs = np.stack([rng.integers(0, h - win + 1, batch),
                         rng.integers(0, w - win + 1, batch)],
                        axis=-1).astype(np.int32)
        flips = rng.integers(0, 2, batch).astype(np.int32)
        return idx, offs, flips, sidx

    def _patch_args_stream(self):
        """Endless per-step host draws: labeled then unlabeled
        ``(idx, offs, flips, sidx)`` for each step, of the global batch;
        under data parallelism this rank's positions of them.

        Sharded splits bound each position's index by its shard's true
        count (the batch splits contiguously over the shards), so that
        cyclic-pad duplicates are never drawn."""
        settings = self.settings
        rng = np.random.default_rng([settings.seed, 1, self._start_step])
        batch = settings.batch_size
        hw = self.labeled_db.image_size
        uhw = self.unlabeled_db.image_size
        n_lab, n_unl = self._labeled_index_bound, self._unlabeled_index_bound
        if self._labeled_local_counts is not None:
            per = batch // data_axis_size(self.data_parallel)
            n_lab = np.repeat(self._labeled_local_counts, per)
            n_unl = np.repeat(self._unlabeled_local_counts, per)
        share = self.data_share
        while True:
            with span("input.draws"):
                draws = (self._random_patch_args(rng, n_lab, hw, batch)
                         + self._random_patch_args(rng, n_unl, uhw, batch))
                step_args = tuple(a[share] for a in draws)
            yield step_args

    def epoch_batch_iterators(self):
        if self.settings.crowd_host_pipeline:
            yield from self._host_epoch_iterators()
            return
        data = self._device_data
        args = self._patch_args_stream()
        steps = self.steps_per_epoch()
        # The window tier's refreshes run on the absolute step clock.
        step_clock = itertools.count(self._start_step)

        def one_epoch():
            for _ in range(steps):
                self._refresh_windows(next(step_clock))
                yield self._sample_batch(
                    data["labeled_images"], data["labeled_density"],
                    data["unlabeled_images"], *next(args))

        while True:
            yield one_epoch()

    # ------------------------------------------------ chunked dispatch loop
    def _prepare_train_chunk(self) -> None:
        """The K-step chunk (``Settings.steps_per_dispatch``): K (sample +
        fused step) iterations, one CUDA graph replay on the card
        (:class:`TrainChunk`), the K steps in a loop on the CPU. It
        consumes the patch-argument rows and the train generator's draws
        in the order K single steps do, so K never changes the data or
        the draws. JAX's refusals, with its messages; on the card also
        what a graph cannot capture: a gloo group (its collectives run
        through the host) and ``debug_nans`` (anomaly mode
        synchronizes)."""
        settings = self.settings
        self.check_settings()
        if self.device.type != "cuda":
            self._train_chunk = self._loop_chunk
            return
        if (self.data_parallel is not None
                and torch.distributed.get_backend() == "gloo"):
            raise ValueError(
                "steps_per_dispatch > 1 on a CUDA card needs NCCL: gloo's "
                "collectives (two ranks on one card) run through the host "
                "and cannot be captured in a CUDA graph; use "
                "steps_per_dispatch=1")
        if settings.debug_nans:
            raise ValueError(
                "steps_per_dispatch > 1 with debug_nans runs on the CPU "
                "only: anomaly mode synchronizes, which a CUDA graph "
                "cannot capture; use steps_per_dispatch=1 to debug on the "
                "card")
        width = sum(int(np.prod(s)) for s in self._patch_arg_shapes())
        self._train_chunk = TrainChunk(
            self._run_chunk_steps, settings.steps_per_dispatch, width,
            self.device, self._rng)

    def check_settings(self) -> None:
        """A patch size that the model's output stride does not divide,
        a model without tensor parallelism under it, and JAX's refusals of
        ``steps_per_dispatch`` > 1, with its messages; ``train()`` checks
        them before it spawns ranks."""
        settings = self.settings
        p, f = settings.image_patch_size, self.output_stride
        if p % f:
            raise ValueError(
                f"image_patch_size={p} is not a multiple of crowd_model "
                f"{settings.crowd_model!r}'s output stride {f}: its maps "
                f"are 1/{f} of the patch's side")
        if (not crowd_model_class(settings.crowd_model).TENSOR_PARALLEL
                and settings.model_parallel_devices > 1):
            raise ValueError(
                f"crowd_model {settings.crowd_model!r} does not run under "
                f"model_parallel_devices > 1 (tensor parallelism covers "
                f"the JointCNN family); use model_parallel_devices=1")
        if settings.steps_per_dispatch <= 1:
            return
        if settings.crowd_host_pipeline:
            raise ValueError(
                "steps_per_dispatch > 1 requires the HBM-resident input "
                "path (crowd_host_pipeline streams host batches one step "
                "at a time)")
        if settings.dnn_only:
            raise ValueError(
                "steps_per_dispatch > 1 supports the fused GAN step only; "
                "dnn_only trials dispatch per step")
        if settings.model_parallel_devices > 1:
            raise ValueError(
                "steps_per_dispatch > 1 is not supported with "
                "model_parallel_devices > 1 (the chunk program replicates "
                "the train state; use per-step dispatch under tp)")

    def _patch_arg_shapes(self) -> List[Tuple[int, ...]]:
        """The shapes of a step's 8 patch-argument arrays on this rank."""
        n = self.settings.batch_size // data_axis_size(self.data_parallel)
        return [(n,), (n, 2), (n,), (n,)] * 2

    def _run_chunk_steps(self, args: torch.Tensor, draws=None
                         ) -> Dict[str, torch.Tensor]:
        """K (sample + step) iterations on the rows of ``args`` [K, A]
        (each a step's :meth:`_flat_args`, on the device); the metrics
        stacked, [K] each. ``draws``, a test's: K dicts of z_d, z_g and α
        to feed the steps in place of the generator's."""
        data = self._device_data
        shapes = self._patch_arg_shapes()
        per_step = []
        for i, row in enumerate(args):
            batch = self._sample_patches(
                data["labeled_images"], data["labeled_density"],
                data["unlabeled_images"], *self._split_args(row, shapes))
            self.state, metrics = self._train_step(
                self.state, *batch, self._rng, **(draws[i] if draws else {}))
            per_step.append(metrics)
        return {k: torch.stack([m[k] for m in per_step])
                for k in per_step[0]}

    def _loop_chunk(self, args: np.ndarray, key=0
                    ) -> Dict[str, torch.Tensor]:
        """The chunk off the card: the K steps in a loop."""
        return self._run_chunk_steps(torch.from_numpy(args))

    def dispatch_chunk(self, args) -> Dict[str, torch.Tensor]:
        """One chunk on the next K steps' draws of the patch-argument
        stream ``args`` (:meth:`_patch_args_stream`): the state advanced K
        steps; the metrics, [K] each (on the card, the graph's outputs,
        which the next chunk overwrites). The chunk's graph is the one of
        the G update's phase at its first step."""
        K = self.settings.steps_per_dispatch
        with span("loop.chunk"):
            stacked = np.stack([self._flat_args(next(args))
                                for _ in range(K)])
            step = self.state.step
            metrics = self._train_chunk(
                stacked,
                key=step % self.settings.generator_training_step_period)
        self.state.step = step + K
        return metrics

    def training_loop(self) -> None:
        if self.settings.steps_per_dispatch > 1:
            self._chunked_training_loop()
        else:
            super().training_loop()

    def _chunked_training_loop(self) -> None:
        """The per-step loop's semantics at K steps a dispatch: summaries
        (the chunk's first step's metrics, as JAX writes ``v[0]``), saves,
        validation and the profiler land on the per-step loop's steps;
        their periods must be multiples of K, so that every period
        boundary is a chunk boundary. Window refreshes land on chunk
        boundaries."""
        settings = self.settings
        K = settings.steps_per_dispatch
        steps_per_epoch = self.steps_per_epoch()
        total_steps = self.total_steps()

        def check(name, value):
            if value and value % K != 0:
                raise ValueError(
                    f"{name}={value} must be a multiple of "
                    f"steps_per_dispatch={K} (period boundaries must be "
                    f"chunk boundaries)")

        check("total training steps", total_steps)
        check("summary_step_period", settings.summary_step_period)
        check("save_step_period", settings.save_step_period or 0)
        if settings.validation_step_period:
            check("validation_step_period", settings.validation_step_period)
        else:
            check("steps_per_epoch (per-epoch validation cadence; set "
                  "validation_step_period to decouple)", steps_per_epoch)
        if self._start_step % K:
            raise ValueError(
                f"resumed step {self._start_step} is not a multiple of "
                f"steps_per_dispatch={K}; resume with steps_per_dispatch=1 "
                f"or a divisor of the checkpoint step")

        args = self._patch_args_stream()
        step = self.state.step
        profile_range = settings.profile_step_range
        profiler = None
        self._last_summary = None
        while step < total_steps:
            if (profile_range and profiler is None and self.is_writer
                    and step <= profile_range[0] < step + K):
                profiler = self._start_profiler()
            self._refresh_windows(step)
            chunk_metrics = self.dispatch_chunk(args)
            if settings.debug_nans:
                for i in range(K):
                    check_finite({k: v[i] for k, v in
                                  chunk_metrics.items()}, step + i)
            if profiler is not None and step + K >= profile_range[1]:
                self._stop_profiler(profiler)
                profiler = None
            self.step_summaries(step, lambda: {
                k: v[0] for k, v in chunk_metrics.items()})
            step += K
            if (settings.save_step_period
                    and step % settings.save_step_period == 0):
                self.save_models()
            if settings.validation_step_period:
                if step % settings.validation_step_period == 0:
                    self.validation_summaries(
                        epoch=step // steps_per_epoch, step=step)
            elif step % steps_per_epoch == 0:
                self.validation_summaries(
                    epoch=step // steps_per_epoch, step=step)
        if profiler is not None:  # the run ended inside the window
            self._stop_profiler(profiler)
        if (not settings.validation_step_period
                and step % steps_per_epoch != 0):
            # The per-step loop also validates after a final partial epoch.
            self.validation_summaries(
                epoch=step // steps_per_epoch + 1, step=step)

    def _host_epoch_iterators(self):
        """The host tier's batches: the labeled prefetcher's uint8 crops,
        the label crops gathered with the same (index, offset, flip), and
        the unlabeled prefetcher's crops, copied two steps ahead.

        Under data parallelism each rank takes its share of the global
        draws of :meth:`_patch_args_stream` and gathers the image and
        label crops of that share alone: the ranks' host work adds up to
        one rank's."""
        steps = self.steps_per_epoch()
        args = (self._patch_args_stream() if self._host_draws_shared
                else None)

        def host_batches():
            for _ in range(steps):
                if args is None:
                    patches, idx, offs, flips = \
                        self._labeled_prefetcher.next_with_params()
                    upatches = self._unlabeled_prefetcher.next()[0]
                else:
                    idx, offs, flips, _, uidx, uoffs, uflips, _ = next(args)
                    patches = self._gather_images(self._labeled_reader, idx,
                                                  offs, flips)
                    upatches = self._gather_images(self._unlabeled_reader,
                                                   uidx, uoffs, uflips)
                yield (patches, self._gather_labels(idx, offs, flips),
                       upatches)

        while True:
            yield prefetch_to_device(host_batches(), self.device)

    def _gather_images(self, reader, idx, offs, flips) -> np.ndarray:
        """uint8 image crops of a native reader (it gathers float32; the
        bytes are exact)."""
        return reader.gather_crops(idx, offs, flips,
                                   self.settings.image_patch_size
                                   ).astype(np.uint8)

    def _gather_labels(self, idx, offs, flips) -> np.ndarray:
        """Label crops at the image crops' (index, offset, flip): [B, P,
        P] density, or [B, P, P, 2] with an aux map."""
        labels = self._density_reader.gather_crops(
            idx, offs, flips, self.settings.image_patch_size)
        return labels[..., 0] if labels.shape[-1] == 1 else labels

    # ----------------------------------------------------------- evaluation
    def _grid_offsets(self, image_hw: Tuple[int, int]) -> np.ndarray:
        """Deterministic patch grid with 50% overlap covering the image."""
        h, w = image_hw
        p = self.settings.image_patch_size
        if min(h, w) < p:
            raise ValueError(
                f"evaluation images ({h}x{w}) are smaller than "
                f"image_patch_size={p}; grid evaluation cannot cover "
                f"them — lower --image_patch_size to <= {min(h, w)} or "
                f"preprocess the database at >= patch resolution")
        stride = max(1, p // 2)
        ys = list(range(0, max(h - p, 0) + 1, stride))
        xs = list(range(0, max(w - p, 0) + 1, stride))
        if ys[-1] != h - p:
            ys.append(h - p)
        if xs[-1] != w - p:
            xs.append(w - p)
        return np.array([(y, x) for y in ys for x in xs], np.int32)

    # Images evaluated per device call.
    EVAL_CHUNK_IMAGES = 8

    def _grid_counts_fn(self, image_hw: Tuple[int, int], use_dnn: bool,
                        return_maps: bool = False):
        """Build (cached) the grid evaluator for one image size:
        ``(model, images, ids[k], masks[k]) → counts[k]``, or the
        overlap-averaged density canvases ``[k, H/f, W/f]`` with
        ``return_maps`` (f: the output stride). One patch-kernel call cuts
        the k·g grid patches; the model runs under
        ``torch.inference_mode``; the g maps add into the canvas in grid
        order, then ``canvas · inv_weight · mask``, the order of JAX's
        ``fori_loop``."""
        key = self._grid_fn_key(image_hw, use_dnn, return_maps)
        if key in self._grid_count_fns:
            return self._grid_count_fns[key]
        p = self.settings.image_patch_size
        f = self.output_stride
        h, w = image_hw
        pf = p // f
        offsets = self._grid_offsets((h, w))
        g = len(offsets)
        # The overlap weights do not depend on the data: their reciprocal
        # is made once on the host.
        weight = np.zeros((h // f, w // f), np.float32)
        for oy, ox in offsets:
            weight[oy // f:oy // f + pf, ox // f:ox // f + pf] += 1.0
        inv_weight = torch.from_numpy(1.0 / np.maximum(weight, 1.0)).to(
            self.device)
        cells = [(int(oy) // f, int(ox) // f) for oy, ox in offsets]
        offsets_full = torch.from_numpy(offsets).to(self.device)
        # With an aux target the density head regresses the aux map, so
        # the counts come from the count head.
        head = 1 if self.uses_aux_target else 0

        def counts_fn(model, images, ids, masks):
            k = ids.shape[0]
            idx = ids.repeat_interleave(g)
            offs = offsets_full.repeat(k, 1)
            patches = extract_patches(
                images, offs, torch.zeros_like(idx), patch_size=p,
                scale=2.0 / 255.0, shift=-1.0, indices=idx)
            with torch.inference_mode():
                maps = model(patches.permute(0, 3, 1, 2))[0][head].float()
                maps = maps.reshape(k, g, pf, pf)
                canvas = torch.zeros((k, h // f, w // f),
                                     dtype=torch.float32, device=self.device)
                for j, (cy, cx) in enumerate(cells):
                    canvas[:, cy:cy + pf, cx:cx + pf] += maps[:, j]
                weighted = canvas * inv_weight * masks
                return weighted if return_maps else weighted.sum(dim=(1, 2))

        self._grid_count_fns[key] = counts_fn
        return counts_fn

    def predict_density_maps(self, use_dnn: Optional[bool] = None,
                             db: Optional[CrowdDatabase] = None,
                             limit: Optional[int] = None) -> np.ndarray:
        """Predicted density maps ``[N, H/f, W/f]`` of a split (default:
        validation): the overlap-averaged grid canvases that the counts
        integrate, ROI masks applied. ``limit`` evaluates only the first
        N examples."""
        return self._predict_grid(use_dnn, db, return_maps=True,
                                  limit=limit)

    def predict_image_counts(self, use_dnn: Optional[bool] = None,
                             db: Optional[CrowdDatabase] = None
                             ) -> np.ndarray:
        """Per-example full-image counts of a split (default: validation).

        When the maps evaluator of the same shapes (image size and ROI
        presence) is already built, the counts are the host sums of its
        canvases, as in the JAX package, which saves a compile there."""
        ref = self.validation_db
        target = db if db is not None else ref
        key = self._grid_fn_key(target.image_size,
                                self._resolve_use_dnn(use_dnn), True)
        same_shapes = (target.image_size == ref.image_size and
                       (target.roi_masks is None) ==
                       (ref.roi_masks is None))
        if same_shapes and key in self._grid_count_fns:
            return self._predict_grid(use_dnn, db,
                                      return_maps=True).sum(axis=(1, 2))
        return self._predict_grid(use_dnn, db, return_maps=False)

    @staticmethod
    def _grid_fn_key(image_hw, use_dnn, return_maps):
        """The one source of the grid evaluators' cache key."""
        return (tuple(image_hw), bool(use_dnn), bool(return_maps))

    def _predict_grid(self, use_dnn: Optional[bool],
                      db: Optional[CrowdDatabase], return_maps: bool,
                      limit: Optional[int] = None) -> np.ndarray:
        use_dnn = self._resolve_use_dnn(use_dnn)
        use_cached_images = db is None or db is self.validation_db
        db = db if db is not None else self.validation_db
        # Under tensor parallelism the parameters are gathered once a
        # pass, as JAX's grid evaluator gathers them.
        model = self.evaluation_model(use_dnn)
        counts_fn = self._grid_counts_fn(db.image_size, use_dnn,
                                         return_maps=return_maps)
        if use_cached_images:
            images = self._device_data["validation_images"]
        else:  # one-shot evaluation of another split: upload it now
            images = torch.from_numpy(db.images).to(self.device)
        # ROI masks: fractional f×f coverage at density resolution;
        # without ROI a broadcastable [N, 1, 1] of ones.
        h, w = db.image_size
        f = self.output_stride
        n = len(db) if limit is None else min(limit, len(db))
        if db.roi_masks is not None:
            mask_ds = db.roi_masks[:n].reshape(
                n, h // f, f, w // f, f).mean(axis=(2, 4)
                                              ).astype(np.float32)
        else:
            mask_ds = np.ones((n, 1, 1), np.float32)
        out_shape = (n, h // f, w // f) if return_maps else (n,)
        counts = np.zeros(out_shape, np.float32)
        # A fixed chunk, a multiple of the ranks, each rank evaluating
        # its block of it: the tail repeats the last id, and the repeats'
        # outputs are dropped.
        dp = self.data_parallel
        d = data_axis_size(dp)
        chunk = -(-self.EVAL_CHUNK_IMAGES // d) * d
        for start in range(0, n, chunk):
            image_ids = np.arange(start, min(start + chunk, n))
            k = len(image_ids)
            if k < chunk:
                image_ids = np.concatenate(
                    [image_ids, np.full(chunk - k, image_ids[-1], np.int64)])
            if dp is not None:
                image_ids = image_ids[dp.share(chunk)]
            ids = torch.from_numpy(image_ids.astype(np.int32)).to(
                self.device)
            masks = torch.from_numpy(mask_ds[image_ids]).to(self.device)
            got = counts_fn(model, images, ids, masks)
            if dp is not None:
                got = gather_rows(got, dp)
            counts[start:start + k] = got.cpu().numpy()[:k]
        return counts

    @staticmethod
    def _count_metrics(db: CrowdDatabase,
                       per_example_pred: np.ndarray) -> Dict[str, float]:
        """Per-source-image count metrics: a tiled database sums its
        tiles' counts by ``image_ids`` first. The truth follows the
        predictions' ROI convention (``CrowdDatabase.roi_head_counts``)."""
        pred = db.per_image_counts(per_example_pred)
        true_counts = db.per_image_counts(db.roi_head_counts())
        return {"MAE": float(metrics.mae(pred, true_counts)),
                "RMSE": float(metrics.rmse(pred, true_counts)),
                "NVE": float(metrics.nve(pred, true_counts)),
                "NAE": float(metrics.count_nae(pred, true_counts))}

    def validation_summaries(self, epoch: int, step: int) -> None:
        """G samples; per model, the validation metrics and, with
        ``crowd_summary_image_count`` > 0, density triptychs from the
        same canvases."""
        write_generated_sample_grid(self, epoch, step)
        if len(self.validation_db) == 0:
            return  # G samples only: no NaN metrics over an empty split
        for use_dnn, writer in ((False, self.gan_summary_writer),
                                (True, self.dnn_summary_writer)):
            if not use_dnn and self.settings.dnn_only:
                continue  # the discriminator is untrained init noise
            if self.settings.crowd_summary_image_count > 0:
                maps = self.predict_density_maps(use_dnn=use_dnn)
                pred = maps.sum(axis=(1, 2))
            else:
                maps = None
                pred = self.predict_image_counts(use_dnn=use_dnn)
            for name, value in self._count_metrics(self.validation_db,
                                                   pred).items():
                writer.add_scalar(f"validation/{name}", value, step)
            if maps is not None:
                self._write_density_triptychs(writer, step, maps)

    @staticmethod
    def _heat(v: np.ndarray) -> np.ndarray:
        """'Hot'-ramp colormap for a [0, 1] map → [H, W, 3] (black → red
        → yellow → white)."""
        return np.clip(np.stack([3 * v, 3 * v - 1, 3 * v - 2], axis=-1),
                       0.0, 1.0)

    def _write_density_triptychs(self, writer, step: int,
                                 maps: np.ndarray) -> None:
        """(input | true density | predicted density) images of the first
        ``crowd_summary_image_count`` validation images; the two density
        panels share one intensity scale. ``maps``: the split's predicted
        canvases."""
        db = self.validation_db
        k = min(self.settings.crowd_summary_image_count, len(db))
        f = self.output_stride
        h, w = db.image_size
        for i in range(k):
            gt = db.density_maps[i].astype(np.float32)
            if db.roi_masks is not None:
                gt = gt * db.roi_masks[i]  # the predictions' convention
            # Sum-pooled to density resolution: cells stay counts.
            gt_ds = gt.reshape(h // f, f, w // f, f).sum(axis=(1, 3))
            pred_map = maps[i]
            scale = float(max(gt_ds.max(), pred_map.max(), 1e-8))
            up = lambda m: np.repeat(np.repeat(m, f, 0), f, 1)
            panels = [db.images[i].astype(np.float32) / 255.0,
                      self._heat(up(gt_ds) / scale),
                      self._heat(up(pred_map) / scale)]
            writer.add_image(f"validation/density_{i}",
                             np.concatenate(panels, axis=1), step)

    def evaluate(self, dataset: Optional[CrowdDatabase] = None,
                 use_dnn: Optional[bool] = None) -> Dict[str, float]:
        """Grid-evaluate ``dataset`` (default: the validation split);
        ``Experiment.test()`` sends the test split here."""
        db = dataset if dataset is not None else self.validation_db
        if len(db) == 0:
            raise ValueError("cannot evaluate an empty dataset (a len-0 "
                             "split must not silently alias validation)")
        pred = self.predict_image_counts(use_dnn=use_dnn, db=db)
        return self._count_metrics(db, pred)
