"""Smoke run of the PyTorch/CUDA port (torch_em_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device and the CUDA
toolkit. Phases, each announced by a flushed ``[smoke +Ns] <phase>`` line:

1. device report (nvidia-smi name and power limit, torch and CUDA versions);
2. build the port's kernels with nvcc for sm_90a, one nvcc per source, all
   started together;
3. hold the forward instance-norm kernel against its plain PyTorch version
   on the card, in float32, bfloat16 and float16, at every shape the
   serving and training paths give it, plus ragged, misaligned, strided and
   channels-last inputs and a bitwise repeat on each kernel path (A, B, C:
   ``ops/instance_norm.py:plan``); time kernel (as called, and device-only
   from a CUDA graph of 20 calls), plain version and the PyTorch library
   call at the serving path's shapes;
4. the serving path: the tracked CREMI AnisotropicUNet at full width, bf16
   compute, through ``predict_with_halo`` with block (32, 512, 512) and halo
   (4, 32, 32) on two seeded volumes, the tracked 64x512x512 (2 blocks) and
   128x1024x1024 (16 blocks), each through the pipelined host path (a numpy
   volume) and the device-resident path (a tensor on the card); after a
   warm-up call, times each call (Mvox/s, ms per block, the forwards' device
   time by CUDA events and the device's idle share over the call) and checks
   the norm kernel's launches, the outputs' shape and range, the two paths
   against each other and the host path against a plain serial block loop
   with host ``standardize``; then one block against the same model with the
   plain instance norm, and a profiler breakdown of one block's forward;
5. the same for the backward instance-norm kernel (plus a non-contiguous
   gradient), and time both kernels, their plain versions and the library
   calls at the training path's shapes;
6. the training path: ``default_segmentation_trainer`` on the tracked model
   at full width, bf16 compute, AdamW at lr 1e-4, 32x256x256 patches,
   batch 1, over ``SegmentationDataset``s of a seeded raw volume and its
   instance labels (connected components of a threshold) written as
   ``.npy`` files to a temporary directory, with the affinity target of
   ``DeviceAffinityTransform`` computed inside the step; fits 24 iterations
   over 2 epochs, rebuilds the trainer with ``DefaultTrainer.from_checkpoint``
   (the transform included) and resumes for 8 more; checks iteration
   counts, a finite and falling loss, both kernels' launch counts and the
   checkpoints; holds the device affinity and boundary transforms against
   the host ones on label patches; times the loader with the host
   ``AffinityTransform`` and with the device transform in the step, the
   bare step, and breaks one down with the profiler; then holds one float32
   training step's gradients with the kernels against the plain versions;
7. the 3-D recipe through the factory: ``default_segmentation_loader`` over
   two seeded ``.npy`` volumes (a ``ConcatDataset`` with the default
   anisotropic flips and ``standardize``) trains the tracked model with
   ``DeviceAffinityTransform`` in the step for 16 iterations, then 4 more
   after ``from_checkpoint``; times the loader feeding steps with no
   transform, with the default flips and with flips and
   ``RandomElasticDeformation3D`` on the host;
8. ``AugmentationPipeline.apply_batched``: every registry entry's apply on
   the card and on the CPU with the same parameters, at batch 1 and 4 of
   32x256x256 patches (the 2-D entries take the 32 planes as channels):
   floats within 1e-5 of the input's range, labels equal but near rounding
   ties; times each entry per batch on the card and per sample on the host;
9. the DSB recipe: ``default_segmentation_loader`` over 16 seeded 2-D
   ``.npy`` images of 200-360 pixels a side (the file list and the
   folder-glob form give equal samples), ``BoundaryTransform`` targets,
   ``UNet2d(1, 2, initial_features=64, Sigmoid)`` in bf16 at batch 8 of
   256x256, 16 iterations and 4 more after ``from_checkpoint``; times the
   loader and the bare step; then ``train_2d_unet`` and
   ``predict_with_tiling`` in subprocesses;
10. the SNEMI recipe (``experiments/snemi/train_snemi.py``): the tracked model
   with a 12-channel affinity head, bf16, trained through
   ``default_segmentation_loader`` over two seeded 64x512x512 volumes of
   space-filling instance labels with the host ``AffinityTransform(12
   offsets, add_mask=True)`` and masked Dice, 16 iterations and 4 more after
   ``from_checkpoint``; holds ``DeviceAffinityTransform`` on the card against
   the host transform, times the loader with either in use and the bare
   step; serves the second volume in blocks of (32, 256, 256) through both
   paths; decodes a (32, 256, 256) crop of the prediction with
   ``mutex_watershed_segmentation`` (timed, non-empty), decodes the exact
   targets of the same ground-truth crop (VOI < 0.05, adapted Rand error <
   0.01 against it), and runs ``validate_checkpoint`` on the card with the
   VOI of the decode of one sample as its metric;
11. the SPOCO recipe (``experiments/spoco/train_spoco_dsb.py``):
   ``SPOCOTrainer`` (momentum 0.999) trains ``UNet2d(1, 8, initial_features=32)``
   embeddings in bf16 at batch 8 of 256x256 with ``SPOCOLoss`` and the
   ``ContrastiveLoss`` metric on phase 9's images through
   ``default_segmentation_loader`` with ``connected_components`` labels, 16
   iterations and 4 more after ``from_checkpoint`` (model2 restored bitwise);
   holds one EMA update on the card against the CPU; times the loader, the
   bare step and the loss, and breaks the step and the loss down with the
   profiler; predicts the embeddings of 4 images on the card and grid-searches
   their embedding mutex watershed on the host (2 deltas x 2 sizes); then
   runs UNet2d and UNet3d with each of the other norms in bf16 on the card
   against the CPU;
12. the ViM-UNet / UNETR recipe (``experiments/vimunet/train_vimunet_livecell.py``):
   ``UNETR(img_size=512, encoder="vit_b", resize_input=True)`` and
   ``get_vimunet_model("vim_t", img_size=512)``, 2 Sigmoid outputs, each at full
   width: built from one seed on the CPU and on the card, the same weights in
   float32 (TF32 off) on both against each other at 512x512 (UNETR also at
   448x448, its encoder's position embedding and relative-position tables then
   shrinking); trained by ``default_segmentation_trainer`` (AdamW 1e-4, bf16,
   batch 4 of 512x512 patches of 8 seeded 704x520 grayscale images through
   ``default_segmentation_loader`` with ``BoundaryTransform(add_binary_target=True)``
   targets) for 8 iterations with ``fit(profile_dir=..., log_mfu=True)`` and 2
   more after ``from_checkpoint``; the bare step timed as called and on the
   device, broken down by the profiler (attention, norms, convs), its peak
   memory and MFU, the SDPA backends that take the float bias and the bias's
   bf16 rounding against float64 (UNETR), one Mamba layer's scan timed forward
   and backward (ViM-UNet); then a 1536x1536 image served in 448x448 blocks with
   a 32 px halo through both paths in bf16; last, ``UNETR3D`` at a small depth
   and width on the card against the CPU;
13. self-training at DSB width (``UNet2d(1, 2, f=64)``, batch 8 of 256x256,
   bf16, AdamW at lr 1e-4) on phase 9's images: the labelled source through
   ``default_segmentation_loader`` with ``BoundaryTransform`` targets, the
   unlabelled target as two views through
   ``get_default_mean_teacher_augmentations``. ``MeanTeacherTrainer``
   semi-supervised with a fresh teacher, then, from its student,
   ``MeanTeacherTrainer`` unsupervised, ``FixMatchTrainerWithInvertible
   Augmentations`` and ``UniMatchv2Trainer`` (``DefaultPseudoLabeler`` at
   confidence 0.9), then ``ProbabilisticUNetTrainer`` on the factory's
   defaults (binary targets, 16 prior samples) and ``FlashOptimTrainer``:
   each 16 iterations with ``fit(log_mfu=True)`` and 4 more after
   ``from_checkpoint`` (the teacher restored bitwise); each bare step timed
   as called and on the device, broken down by the profiler with the norms'
   and the teacher forward's shares, its peak memory and MFU; the teacher's
   moving average, the invertible augmenters (the 16 geometric draws undone
   bitwise, blur and noise against the CPU), the pseudo-labels and the
   Probabilistic U-Net (float32, TF32 off, a given noise draw) on the card
   against the CPU; FlashOptim's parameters and moments bf16;
14. the other encoder families in UNETR, each at its published width with 2
   Sigmoid outputs and ``resize_input`` on phase 12's images (512x512 patches,
   BoundaryTransform targets, bf16, AdamW 1e-4): SAM2 hvit_b at 1024 without
   skips and DINOv2 vit_b at 518 (batch 2 and 4) through
   ``default_segmentation_trainer`` (8 iterations, ``from_checkpoint``, 2 more;
   a falling loss, weights that move) and 1536x1536 served through both paths;
   DINOv3 vit_b at 512, MAE vit_b at 224, ScaleMAE vit_l at 224 (batch 4) and
   SAM3 vit_pe at 1008 (batch 2) each with a trainer for the step. For each:
   card against CPU in float32 (TF32 off) at a reduced depth and size (outputs
   and encoder features within 1e-4 of the largest value), one training step
   with its norm launches counted, timed as called and on the device, profiled
   (attention, norm and conv shares, idle), its FLOPs, MFU and peak memory, and
   a bf16 forward. Then ``resnet3d_50(1, 4)`` through
   ``default_classification_loader`` over seeded 1x64x64x64 volumes of 4
   classes and ``default_classification_trainer(logger=None)``: 8 iterations,
   ``from_checkpoint``, 4 more, the accuracy error of the numpy metric, the
   step's time, MFU and peak memory;
15. the multi-device paths (``parallel/``) with the tracked model at full
   width on the one card: (a) ``train_multi_gpu`` in one process over NCCL
   with phase 6's recipe (8 iterations, rank 0 writing), a resume through
   ``DefaultTrainer.from_checkpoint`` in a process group of one, and a
   ``save_sharded_checkpoint``/``restore_sharded_checkpoint`` round trip of
   its state (bitwise); (b) two processes sharing the card over gloo: one
   data-parallel step against the step of one process on both patches
   (float32, TF32 off), bf16 steps with a falling loss, ``halo_sharded_
   predict`` of a 128x512x512 volume with the derived 36-plane halo against
   ``predict_with_halo`` in (64, 512, 512) blocks, and ``spatial_sharded_
   train_step`` on a (96, 256, 256) patch with the kernels against the plain
   norms; each process reports its norm launches, times, the all-reduce's
   and the halo exchange's ms and its peak memory; (c) ``predict_with_halo``
   with two replicas on the card against one, and ``validate_checkpoint``
   with two ids;
16. the Shallow2Deep recipe with no sklearn (the phase fails where it was
   imported, and where a ``sklearn`` module stands in ``sys.modules`` at its
   end): (a) ``fit_forest`` refits every forest fixture of
   ``scripts/make_forest_fixtures.py`` (data made anew from their seeds; every
   argument of ``RandomForestClassifier``: class weights, best-first trees,
   pruning, the out-of-bag score, warm start, monotonic constraints) and
   holds each against sklearn's recorded trees node for node, the
   out-of-bag arrays bitwise, with each fit's seconds; (b)
   ``prepare_shallow2deep`` refits the committed forests
   of ``scripts/s2d_forests/`` by their recipe (``scripts/torch_s2d_forests.py``:
   seed 0, one thread, 4 forests of 10 trees, 128-192 pixel patches), writes
   each as ``.npz`` and as sklearn's ``.pkl`` (no sklearn), with
   its seconds, whether its features' sha256 equals the one recorded on the
   CPU, and whether the forests equal the committed ones node for node
   (unequal trees fail where the features are equal); (d) the committed
   sklearn pickles of the fixtures (``sklearn_pickles.zip``) read with
   ``load_forest`` node for node against their ``.npz`` records, the port's
   pickle of one refitted fixture against the sha256 recorded on the CPU,
   (b)'s pickles against their ``.npz``, and the ms of reading and writing
   a pickle of (b)'s size; (c)
   ``prepare_shallow2deep_advanced`` with ``worst_tiles``, 2 stages of 2
   forests of 10 trees, its stage-2 sample counts checked and every forest's
   probabilities in [0, 1], with its seconds; per 256x256 patch the host's
   ms in the filter bank and in ``predict_proba`` of (b)'s forests; the
   enhancer ``UNet2d(1, 1, depth 4, f=64, Sigmoid)`` on (b)'s forests'
   predictions, read from their ``.pkl`` files,
   through ``get_shallow2deep_loader`` over the script's eight 512x512
   images (forest probabilities in, foreground out), bf16, batch 8 of
   256x256, DiceLoss, AdamW 1e-4, 8 iterations and 2 more after
   ``from_checkpoint`` (more than half of the weights move); the loader with
   thread and process workers, the bare step, the float32 forward on the
   card against the CPU; ``export_bioimageio_model`` of the checkpoint with
   ``get_shallow2deep_config``, its validation, ``import_bioimageio_model``
   on the card (bf16 forward bitwise equal to the trainer's model), the
   torchscript weights (traced on the CPU) on the card against the
   state-dict model; ``Shallow2DeepModel`` on the two 512x512 test images
   (forest on the host, enhancer on the card), its soft Dice and the
   forest's; a seeded volume as ``.nii.gz`` and ``.mha`` read back through
   ``load_data`` and a ``SegmentationDataset`` patch of the NIfTI file;
17. the dataset zoo's EM readers: (a) the CREMI recipe's tracked model (bf16, AdamW at lr
   1e-4, 32x256x256, batch 1, ``labels_to_binary`` targets, the zoo's default augmentations)
   through ``get_benchmark_loader(path, 5, ...)`` over MitoLab benchmark 5's layout at its
   published shape (165, 768, 1024), two multi-page TIFFs written with PIL; (b)
   ``UNet2d(1, 1, f=64, Sigmoid)`` through ``get_mitolab_loader`` on 256 seeded 224x224 TIFF
   pairs in CEM-MitoLab's layout (the numpy split, ``non_empty_images.json``), batch 8; each
   8 iterations and 2 more after ``from_checkpoint``, its loader timed with thread (and, for
   (a), process) workers beside the bare step, the TIFFs' decode timed, and the first samples
   of each zoo dataset held equal to those of a dataset over the same arrays in memory;
18. the dataset zoo's light-microscopy readers: (a) the DSB recipe's ``UNet2d(1, 2, f=64)``
   through ``get_dsb_loader`` on dsb2018's layout at its published 447 + 50 images (and a
   batch of the SPOCO recipe's loader, int32 components); (b) the ViM-UNet / UNETR recipe's
   UNETR vit_b through ``get_livecell_loader`` on LIVECell's layout, its COCO polygons
   converted on first use and held against the drawn cells; each as phase 17's;
19. the dataset zoo's histopathology and medical readers: (a) ``UNet2d(3, 2, f=64, Sigmoid)``
   (the DSB recipe's model on H&E input) with boundaries, batch 8 of 512x512, through
   ``get_monuseg_loader`` on MoNuSeg's extracted layout, 8 + 2 seeded 1000x1000 RGB TIFFs with
   Aperio XML of 720 polygons each, rasterized on first use (timed per image) and held equal
   to the polygons drawn, one instance each; (b) ``UNet3d(1, 16, f=32, Sigmoid)`` on
   ``OneHotTransform(16)`` targets, batch 2 of (128, 128, 64) in (X, Y, Z) order, through
   ``get_amos_loader(modality="CT")`` on AMOS' layout, 4 + 2 seeded int16 CT volumes of
   512x512x128 written with ``medical_io.save_nifti`` (each volume's gunzip and decode timed,
   read back equal); each as phase 17's (fit, resume, thread loader beside the bare step, the
   zoo's samples against the arrays in memory);
20. the quality probes' paths through the functions of ``scripts/torch_parity2d.py`` and
   ``scripts/torch_parity3d.py``, 20 iterations each, scored on the best checkpoint by the
   scripts' evaluators: (a) the DSB probe, ``UNet2d(1, 2, f=16, Sigmoid)`` at batch 4 of
   128x128, on its whole seed-42 data (labels checked against the tracked files' sha256);
   (b) the tracked DSB, f=64 at batch 8 of 256x256, on its first 32 train and 4 val images;
   (c) the tracked CREMI model on one train and one val volume of 40x320x320, batch 1 of
   32x256x256, ``DeviceBoundaryTransform`` on the card, scored on the (0:32, 0:256, 0:256)
   crop; each with its launches (steps, validations, the scores' forwards), a finite and
   falling loss and scores in [0, 1]; then (d) the
   SPOCO probe through ``scripts/torch_spoco2d.py``, ``UNet2d(1, 8, f=16)`` at batch 4 of
   128x128 in float32 with its moving-average network, the grid-searched embedding decode of
   the 8 tune images and the VOI / Rand scores of the 8 held-out ones, and (e) the SNEMI
   probe, ``AnisotropicUNet(1, 7, f=8)`` with ``[[1, 2, 2], [2, 2, 2]]`` at batch 1 of
   8x64x64 in bf16 on affinity targets, 150 iterations (its loss moves more from patch to patch
   than in 20), decoded by the mutex watershed on both val crops; each with its launches (two
   forwards a SPOCO step and a SPOCO validation batch), a finite and falling loss and finite
   scores. All five run with TF32 off and deterministic algorithms on
   (``torch_parity3d.deterministic``, the scripts' ``--deterministic``; flags printed). The
   full runs are the scripts';
21. the public names ``ConvBlock2d``, ``ConvBlock3d``, ``Upsampler2d`` and ``Upsampler3d``
   (both upsampling modes) built on the card at the tracked widths, each held bitwise against
   its ``ConvBlock(..., dim)`` or ``Upsampler(..., dim)`` form on the same weights and bf16
   input, deterministic cuDNN; and ``ops.native.is_available()``; every
   ``sklearn.metrics`` score that ``ClassificationMetric`` computes in numpy,
   on the recorded label vectors of ``scripts/records/forest/``, against
   sklearn's recorded values (abs 1e-12).
22. HDF5 with no h5py (``utils/hdf5.py``): (a) ``bench.py``'s loader volume (64x512x512 float32
   raw, uint32 labels, (32, 128, 128) chunks) written by the port, once with no filter and once
   with gzip (``write_data``), write seconds and sizes; the reader's MB/s over random 32x256x256
   windows; (b) the tracked AnisotropicUNet (bf16, ``DiceLoss``, AdamW at lr 1e-4) trained 8
   steps and resumed for 2 from ``SegmentationDataset`` over the h5 file with ``AffinityTransform``
   on the host and thread workers, the loader's patches/s from both files beside the bare step's
   and phase 7's ``.npy`` loader; (c) the 12 tracked ``experiments/parity/parity_data*/**/*.h5``
   files read by the port, each labels volume's sha256 held against the one the parity scripts
   give it (``torch_parity2d.LABELS_SHA256``, ``torch_parity3d.make_data``'s regenerated volumes),
   and ``default_segmentation_loader`` over ``parity_data3d/train/vol*.h5`` into the 3-D probe
   model for a few steps; (d) an LZF-filtered dataset grown tile by tile, as
   ``orion_crc.py`` writes it, read back through the native LZF build.
23. zarr v2 and N5 with no tensorstore, zarr-python or h5py (``utils/zarr_n5.py`` and the native
   blosc build of ``ops/native/blosc.cpp``, whose build time it prints; the three packages are
   blocked for the phase): (a) phase 22's loader volume written by ``write_data`` once as zarr
   and once as N5 (blosc lz4), write seconds and sizes, and one thread's MB/s over random
   32x256x256 windows, the chunks of a window decoded one after another and on the module's
   thread pool, each window equal to the arrays in memory; (b) the tracked AnisotropicUNet
   (bf16, ``DiceLoss``, AdamW at lr 1e-4) trained 8 steps and resumed for 2 from
   ``SegmentationDataset`` over the zarr volume with ``AffinityTransform`` on the host and 4
   thread workers, the loader's patches/s from zarr and from N5 beside the bare step's and phase
   7's, and a few batches of the N5 volume through ``worker_mode="process"`` (the lazy arrays
   pickled into spawned workers) into the steps; (c) every fixture of
   ``scripts/make_zarr_n5_fixtures.py`` (tensorstore's c-blosc and other codecs, written on a
   CPU) read equal to its array regenerated from its seed; (d) the CLI's ``predict`` from a
   32x256x256 crop of the zarr raw with (b)'s checkpoint to ``-o pred.n5 --output_key pred
   --chunks 16 128 128``, read back bitwise equal to ``predict_with_padding`` of the same model
   on the same input in this process under deterministic algorithms; (e)
   ``get_platynereis_cell_loader`` over nine N5 volumes in its layout into the tracked model and
   ``get_tissuenet_loader`` over TissueNet's npz splits, which it converts to zarr, into
   ``UNet2d`` at DSB width, each 4 steps and 2 more after ``from_checkpoint``.
24. training logs and HDBSCAN with no tensorboardX, tensorboard, sklearn or matplotlib (blocked
   for the phase): (a) the tracked AnisotropicUNet through ``default_segmentation_trainer`` with
   no ``logger`` argument, 8 steps and 2 more after ``from_checkpoint`` at
   ``log_image_interval=4``; its TensorBoard events, read back with the port's ``read_events``
   (both CRCs of every record checked), hold one ``train/loss`` per step equal to the trainer's
   loss in float32, the learning rate, ``validation/loss`` and ``/metric`` at each validation,
   and images at steps 0, 4 and 8 whose PNGs decode to the grids' shapes; the training epochs'
   ms per iteration against the same fits with ``logger=None``, in turns; (b) ``SPOCOTrainer``
   (the SPOCO recipe), ``MeanTeacherTrainer`` (unsupervised, DSB width) and
   ``default_classification_trainer`` (``resnet3d_50``) with their default loggers, 2 steps and
   1 more after ``from_checkpoint``, writing the JAX loggers' tags (``validation/confusion_matrix``
   among them); (c) every fixture of ``scripts/make_hdbscan_fixtures.py`` (sklearn's labels and
   tree, written on a CPU): the native tree bitwise, the labels from sklearn's edge order equal,
   and the labels of ``ops.native.hdbscan`` equal where this numpy's ``argsort`` orders the
   edges as the recorded one or the case is free of the order of equal weights; then
   ``HDBScanRandMetric`` on (b)'s SPOCO embeddings of two DSB crops of 128x128 (16384 points of 8
   dimensions each), its seconds, and the labels on one thread equal to those on torch's.
25. the dataset zoo's conversions with no pydicom, nibabel, imageio, pycocotools, geopandas, rasterio or
   shapely (blocked for the phase): (a) 3D-IRCADb's archive of DICOM files, one a slice, two train
   patients and one val patient of 96 slices of 512x512 int16 CT (BitsStored 12) with a uint8 liver
   mask series, in explicit VR little endian (its masks deflated), implicit VR little endian and RLE
   Lossless, written from a seed; ``get_ircadb_loader`` unpacks and converts them to gzip h5 (each
   held equal to the series written), and phase 19b's UNet3d with one output (bf16) trains 4 steps and
   2 more after ``from_checkpoint`` on (64, 128, 128) patches in the h5's (Z, Y, X) order; the
   conversion's seconds a volume, an RLE slice's read time and the loader's patches/s beside the bare
   step; (b) PUMA's layout, four 1024x1024 RGBA ROI TIFFs with a GeoJSON of 300 seeded nuclei each
   (some with a hole, some MultiPolygons), rasterized on first use, the instance and semantic masks
   held against a brute-force pixel-centre even-odd reference, and UNet2d at DSB width (phase 19a's
   batch and patch) trained 4 + 2 steps; (c) OrgLine's COCO conversion (compressed-RLE ellipses and
   polygon rectangles), UroCell's NIfTI volumes, ``write_data``'s PNG and TIFF round trips (multi-page
   stacks), a Parhyale hyperstack, and HEST's CellViT GeoJSON and Xenium WKB nuclei at 0.5 and 0.25
   um/px, each held against what was written.

Phases 1 to 7, 22, 23 and 15 run one after another in this process, alone on the card: the
kernels' times of the last lines come from phases 3 and 5, phases 22's and 23's loader rates
are compared with phase 7's, and phase 15's two ranks need 50 GiB of the card. The other phases
of 8 to 21, and phases 24 and 25, then run at the same time in ``FANOUT`` groups, each
group one child process (``chip_smoke.py --phases 12,14``) that runs its phases in order on the
same card, with a share of the host's cores; the child's lines, on a clock that starts with this
process, are printed when all groups have ended, and a failed group stops the others. Times
printed by those phases are therefore taken beside the other groups' work.

Phases 3 and 5 also hold both kernels at the self-training steps' shapes
(UniMatch v2's student at batch 16 of the DSB shapes; the Probabilistic
U-Net's U-Net, widths 32 to 384, at batch 8) and at phase 17's MitoLab step's
(batch 8, 224x224 down to 14x14), and at the DSB and SPOCO steps' shapes
(batch 8, rows 8 x C from 8 x 1 to 8 x 1024 and 8 x 512, 65536 down to 256
elements), and phase 5 times them there. Phase 3 also holds the forward kernel at the SNEMI
recipe's serving blocks (40x320x320 with the halo) and validation blocks
(24x192x192), whose norms phase 10 launches, and both kernels at the UNETR
and ViM-UNet decoders' shapes (phase 12: 3 to 768 channels, 32x32 to
512x512; the forward at batch 4 and 1, the backward at batch 4) and the
encoder families' decoders (phase 14: 14x14 to 1152x1152, among them the rows
of 1369, 5476 and 268324 elements off the 16-byte grid and SAM3's path-C head;
the forward at their training batch and 1, the backward at their training
batch), where phase 5 also times them per training step. Phases 3 and 5 also
hold both kernels at the sharded paths' slabs with their 36-plane halo (phase
15: 136x512x512 served, level-0 rows of 35.6 M elements and a 64-channel norm
of 2.28e9 elements; 120x256x256 trained), checked against the plain versions
channel group by channel group, and time them at those slabs' level-0 rows.
Phase 3 also holds the forward kernel at the rows of ``Shallow2DeepModel``'s
enhancer on two 512x512 images (batch 2, 1 to 1024 channels), which phase 16
launches in float32. Phases 3 and 5 also hold both kernels at phase 18's DSB
test tail (batch 2) and at phase 19's steps, and phase 5 times them per step
there: UNet2d f=64 at batch 8 of 512x512 from 3 input channels (rows 8 x 3 to
8 x 1024, 262144 down to 4096 elements) and UNet3d f=32 at batch 2 of (128,
128, 64) with isotropic pooling (rows 2 x 1 to 2 x 512, 1048576 down to 2048
elements), and phase 25a's UNet3d at batch 2 of (64, 128, 128) (the same rows;
25b takes 19a's); and at phase 20's DSB probe, UNet2d f=16 at batch 4 of 128x128 (rows
4 x 1 to 4 x 256, 16384 down to 64 elements), which the SPOCO probe (20d) shares,
and at phase 20e's SNEMI probe, AnisotropicUNet f=8 with [[1, 2, 2], [2, 2, 2]] at
batch 1 of 8x64x64 (rows 1 x 1 to 1 x 32, 32768 down to 1024 elements), where phase 5
times them per step. Phase 3 also holds the forward kernel at batch 4 of the DSB rows
(f=64, 256x256), phase 20's scoring forwards.

The last three lines are the card's name and power limit, a JSON line with
one entry per kernel, and ``{"ok": true, "device": {...}}``. Without a CUDA
device, or when any phase fails, it exits nonzero and prints no result line.
"""

import contextlib
import ctypes
import glob
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import traceback
import unittest.mock
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

T0 = time.perf_counter()
# a child process of the fan-out logs on the clock of the process that started it
if "CHIP_SMOKE_T0" in os.environ:
    T0 -= time.time() - float(os.environ["CHIP_SMOKE_T0"])

TRACKED = dict(
    in_channels=1, out_channels=1, scale_factors=[[1, 2, 2], [1, 2, 2], [2, 2, 2], [2, 2, 2]],
    initial_features=32, final_activation="Sigmoid", anisotropic_kernel=True,
)
VOLUME_SHAPE = (64, 512, 512)
# the tracked volume, and one of 16 blocks (512 MiB of float32) for the pipeline to overlap
SERVING_VOLUMES = (VOLUME_SHAPE, (128, 1024, 1024))
BLOCK_SHAPE = (32, 512, 512)
HALO = (4, 32, 32)
NORMS_PER_FORWARD = 18  # 9 ConvBlocks x 2 instance norms
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# kernel against plain version: float32 sums in another order; bfloat16 may
# differ by one rounding step of the output (2**-7 of its magnitude); float16
# by one step (2**-10 of its magnitude) beside 1e-5 of the largest value
F32_ATOL = 1e-4
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5
F16_RTOL, F16_RTOL_OF_MAX = 2.0 ** -10, 1e-5
# one halo block through the model, kernel against plain norm: float32 with
# TF32 off; bf16 rounding flips of single norm outputs spread through convs
MODEL_F32_ATOL = 1e-4
MODEL_BF16_MAX, MODEL_BF16_MEAN = 2e-2, 1e-3
# backward kernel against plain version: float32 within 1e-4 of the largest
# |dx|; bfloat16 and float16 one rounding step of the output beside 1e-5 of
# the largest
BWD_F32_RTOL_OF_MAX = 1e-4
BWD_BF16_RTOL, BWD_BF16_RTOL_OF_MAX = 2.0 ** -7, 1e-5
BWD_F16_RTOL = 2.0 ** -10
# device-only time: calls captured in one CUDA graph
GRAPH_CALLS = 20
# the training path
TRAIN_VOLUME = (48, 384, 384)
TRAIN_PATCH = (32, 256, 256)
TRAIN_SAMPLES, VAL_SAMPLES = 12, 2
FIT_ITERATIONS, RESUME_ITERATIONS = 24, 8
LEARNING_RATE = 1e-4
# the tracked benchmark's affinity offset (one output channel)
OFFSETS = [[-1, 0, 0]]
LOADER_THREADS, LOADER_STEPS = 4, 8
# the 3-D recipe through the factory (phase 7): two volumes, 16 iterations, 4 more after the resume
RECIPE_FIT, RECIPE_RESUME = 16, 4
FLIPS_3D = ["RandomHorizontalFlip3D", "RandomVerticalFlip3D", "RandomDepthicalFlip3D"]
# apply_batched on the card against the CPU (phase 8): float outputs within 1e-5 of the
# input's range; labels equal but where a coordinate lies within 1e-4 of a rounding tie,
# at most 1e-4 of the voxels
AUG_SHAPE, AUG_BATCHES = (32, 256, 256), (1, 4)
AUG_FLOAT_TOL, AUG_TIE, AUG_TIE_SHARE = 1e-5, 1e-4, 1e-4
# the DSB recipe (phase 9): experiments/dsb/train_dsb.py
DSB_MODEL = dict(in_channels=1, out_channels=2, initial_features=64, final_activation="Sigmoid")
DSB_DEPTH, DSB_BATCH, DSB_PATCH = 4, 8, (1, 256, 256)
DSB_IMAGES, DSB_FIT, DSB_RESUME, DSB_CLI_ITERATIONS = 16, 16, 4, 4
# the SNEMI recipe (phase 10): experiments/snemi/train_snemi.py, 12 offsets, masked Dice
SNEMI_OFFSETS = [[-1, 0, 0], [0, -1, 0], [0, 0, -1], [-2, 0, 0], [0, -3, 0], [0, 0, -3],
                 [-3, 0, 0], [0, -9, 0], [0, 0, -9], [-4, 0, 0], [0, -27, 0], [0, 0, -27]]
SNEMI_VOLUME, SNEMI_CELL = (64, 512, 512), (8, 48, 48)
SNEMI_FIT, SNEMI_RESUME = 16, 4
SNEMI_BLOCK = (32, 256, 256)
SNEMI_DECODE = (32, 256, 256)
SNEMI_VALIDATE, SNEMI_VALIDATE_BLOCK = (16, 128, 128), (16, 128, 128)
# mutex watershed of the exact affinity targets of a ground-truth crop against that ground truth
ORACLE_VOI, ORACLE_ARE = 0.05, 0.01
# the SPOCO recipe (phase 11): experiments/spoco/train_spoco_dsb.py, 8-dim embeddings, the DSB data and
# batch; decoded with the embedding mutex watershed of experiments/parity/train_spoco2d.py
SPOCO_MODEL = dict(in_channels=1, out_channels=8, initial_features=32)
SPOCO_DEPTH, SPOCO_FIT, SPOCO_RESUME, SPOCO_MOMENTUM = 4, 16, 4, 0.999
SPOCO_LOSS = dict(delta_var=0.75, delta_dist=2.0)
SPOCO_OFFSETS = [[-1, 0], [0, -1], [-3, 0], [0, -3], [-9, 0], [0, -9]]
SPOCO_DECODE_IMAGES, SPOCO_GRID = 4, {"delta": [1.5, 2.0], "min_seg_size": [50, 100]}
# one EMA update of model2 on the card against t * m + s * (1 - m) on the CPU from the same float32
# tensors: the card may fuse a multiply-add, one rounding step apart
EMA_RTOL, EMA_ATOL = 1e-6, 1e-7
# the other norms (phase 11), each in a UNet2d and a UNet3d (16 features, two levels, batch 2: GroupNorm
# takes groups of 2 channels at the base, BatchNorm sums over the batch), in training mode from the same
# weights and input, on the card in bfloat16 and in float32 (TF32 off), on the CPU in bfloat16, float32
# and float64. Errors are relative L2 from float64 on the CPU, over the output, and over all parameter
# gradients together. Some gradients are sums with cancellation, and no fixed bound fits them: the CPU's
# own float32 gradients of UNet3d with BatchNorm lie 3.3e-3 from float64 (one tensor 4.5%), its bf16
# ones 5-9% (single tensors 10-35%); the first calls on the card held single tensors to bounds of their
# own and failed there (the first norm's scale, a sum over 8192 products: 0.96 of its norm off in bf16
# on the card against 0.17 on the CPU) and then a fixed 1e-3 in float32 (3.3e-3 on the card, as on the
# CPU). So, as phase 6 holds its kernels, the card in each dtype within 4x the CPU's error in that dtype,
# plus 1e-5 (float32) or 2% (bfloat16). A wrong norm, forward or backward, moves either by its own size.
NORM_VARIANTS = ("InstanceNormTrackStats", "GroupNorm", "BatchNorm")
# the ViM-UNet / UNETR recipe (phase 12): experiments/vimunet/train_vimunet_livecell.py, two models at
# 512x512, batch 4, mixed precision, AdamW at lr 1e-4, foreground and boundary targets of
# get_livecell_loader(boundaries=True); seeded synthetic grayscale images of LIVECell's 704x520
VIT_RECIPES = (
    ("UNETR", "UNETR", dict(img_size=512, encoder="vit_b", out_channels=2, resize_input=True,
                            final_activation="Sigmoid")),
    ("ViM-UNet", "get_vimunet_model", dict(out_channels=2, model_type="vim_t", img_size=512,
                                           final_activation="Sigmoid")),
)
LIVECELL_SHAPE, VIT_IMAGES = (520, 704), 10  # 8 to train on, 2 to validate on
VIT_PATCH, VIT_BATCH, VIT_FIT, VIT_RESUME = (1, 512, 512), 4, 8, 2
VIT_SERVE, VIT_BLOCK, VIT_HALO = (1536, 1536), (448, 448), (32, 32)
# the same weights on the CPU and on the card in float32 (TF32 off): sigmoid outputs within 1e-3,
# encoder features within 1e-3 of their largest magnitude; float32 sums in another order drift
# through 12 transformer blocks or 24 Mamba layers (1.1e-4 on the CPU against the JAX package
# through vim_t), a wrong layer moves them by its own size
VIT_CPU_ATOL, VIT_FEATURE_RTOL = 1e-3, 1e-3
# UNETR3D at a small depth and width on the card against the CPU (float32, TF32 off)
UNETR3D_SMALL = dict(img_size=64, encoder="vit_t", out_channels=2, embed_dim=96, depth=4, num_heads=3,
                     global_attn_indexes=(1, 3))
ATTENTION_KERNELS = re.compile(r"fmha|flash|attention|sdpa", re.I)
# the other encoder families in UNETR (phase 14), each at its published width: (name, UNETR arguments, training
# batch, the encoder features' channels, their grid). 2 Sigmoid outputs, resize_input, bf16, AdamW at lr 1e-4,
# BoundaryTransform targets of phase 12's LIVECell-sized images in 512x512 patches (resized to img_size and
# back); batch 4 at 224-518 px, 2 at 1008-1024 px. ScaleMAE resizes its input to 448 (a 56x56 grid of patch 8).
FAMILY_RECIPES = (
    ("sam2", dict(img_size=1024, backbone="sam2", encoder="hvit_b", use_skip_connection=False), 2, 256, 64),
    ("dinov2", dict(img_size=518, backbone="dinov2", encoder="vit_b", use_dino_stats=True), 4, 768, 37),
    ("dinov3", dict(img_size=512, backbone="dinov3", encoder="vit_b", use_dino_stats=True), 4, 768, 32),
    ("mae", dict(img_size=224, backbone="mae", encoder="vit_b", use_mae_stats=True), 4, 768, 14),
    ("scalemae", dict(img_size=224, backbone="scalemae", encoder="vit_l", use_mae_stats=True), 4, 1024, 56),
    ("sam3", dict(img_size=1008, backbone="sam3", encoder="vit_pe"), 2, 1024, 72),
)
FAMILY_COMMON = dict(out_channels=2, final_activation="Sigmoid", resize_input=True)
# the two that also train through default_segmentation_trainer (fit, from_checkpoint, resume) and serve
# 1536x1536 through predict_with_halo (both paths)
FAMILY_ENTRY, FAMILY_FIT, FAMILY_RESUME = ("sam2", "dinov2"), 8, 2
# UNETR without skip connections: the first norm reads the encoder's features, which need a gradient
NO_SKIP = ("vimunet", "sam2")
# card against CPU (float32, TF32 off), each family at a reduced depth and size: outputs and encoder features
# within 1e-4 of their largest value
FAMILY_SMALL = {
    "sam2": dict(img_size=128, stages=(1, 1, 2, 1), global_att_blocks=(3,)),
    "dinov2": dict(img_size=112, depth=9),
    "dinov3": dict(img_size=128, depth=9),
    "mae": dict(img_size=64, depth=4),
    "scalemae": dict(img_size=64, depth=4, input_size=112),
    "sam3": dict(img_size=168, depth=6, global_attn_indexes=(1, 3, 5)),
}
FAMILY_CPU_RTOL = 1e-4
# classification (phase 14): resnet3d_50(1, 4) through default_classification_loader / _trainer on seeded
# 1x64x64x64 volumes of 4 classes (smoothed noise, the smoothing by class), batch 4, bf16, AdamW at lr 1e-3
CLS_SHAPE, CLS_CLASSES, CLS_BATCH, CLS_TRAIN, CLS_VAL = (1, 64, 64, 64), 4, 4, 16, 8
CLS_FIT, CLS_RESUME = 4, 4
# self-training (phase 13): the DSB model and batch on phase 9's images, AdamW at lr 1e-4, bf16 compute; the
# labelled source takes BoundaryTransform targets, the unlabelled target the same images through
# get_default_mean_teacher_augmentations as two views; 16 iterations and 4 more after from_checkpoint per
# trainer. The Probabilistic U-Net at the JAX factory's defaults on binary foreground targets.
ST_FIT, ST_RESUME, ST_CT = 16, 4, 0.9
PUNET_FILTERS, PUNET_PRIOR_SAMPLES = [32, 64, 128, 192], 16
# card against CPU: the strong augmenter's blur and noise with given parameters within 1e-6 (float32 sums of
# three taps); the Probabilistic U-Net's forward and ELBO in float32 with TF32 off, with a given noise draw,
# within 1e-4 of the largest value; pseudo-labels and masks equal
ST_AUG_ATOL, PUNET_RTOL, PUNET_CHECK_BATCH = 1e-6, 1e-4, 2
VARIANT_FACTOR, VARIANT_SLACK = 4.0, {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# one float32 training step (TF32 off), kernels against plain versions, both
# held against the same step in float64 with the plain versions. The float32
# gradients of this model are themselves inexact in the deep levels on either
# path (sums over millions of voxels with cancellation, and ReLU inputs that
# float32 rounding moves across zero), so the check is relative to the plain
# path: each parameter's gradient with the kernels must lie within 4x the
# plain version's L2 distance from the float64 gradient, plus 1e-5 of the
# model's largest |grad| per element (tensors whose true gradient is zero,
# such as the upsamplers' biases, which the next norm removes, hold only
# rounding noise). A wrongly wired or wrong backward moves a gradient by its
# own size, far beyond this.
GRAD_L2_FACTOR, GRAD_ATOL_OF_MODEL = 4.0, 1e-5
# the multi-device paths (phase 15), one card: 15a trains through train_multi_gpu in one process over NCCL
# (phase 6's recipe) and resumes with from_checkpoint in a process group of one; 15b runs two processes
# on the card over gloo: one data-parallel step (a 32x256x256 patch per process) against the step of one
# process on both patches (float32, TF32 off, deterministic cuDNN: loss rel 1e-4 and parameters atol 1e-4
# after SGD at lr 1e-2, the JAX package's test), then bf16 steps with AdamW; halo_sharded_predict of a
# 128x512x512 volume in z with the derived 36-plane halo against predict_with_halo in (64, 512, 512) blocks
# with halo (36, 0, 0); spatial_sharded_train_step on a (96, 256, 256) patch with the kernels against the
# plain norms (float32, TF32 off); 15c predicts with two replicas on the card and validates 15a's checkpoint
MD_TRAIN_SAMPLES, MD_VAL_SAMPLES, MD_FIT, MD_RESUME = 8, 1, 8, 4
MD_DP_LR, MD_LOSS_RTOL, MD_PARAM_ATOL = 1e-2, 1e-4, 1e-4
MD_BF16_STEPS = 6
MD_HALO_VOLUME, MD_HALO_BLOCK = (128, 512, 512), (64, 512, 512)
MD_SPATIAL_PATCH = (96, 256, 256)
MD_PROCESSES = 2
MD_ONE_PROCESS_BACKEND = "nccl"  # 15a: the default backend of one process per card
# the spatial step's gradients, kernels against plain norms (float32, TF32 off): phase 6 measured the two
# 0.5-0.7% of a tensor's norm apart in this model (both as far from float64); per tensor within 5% of its
# norm plus 1e-5 of the model's largest gradient per element, and all together within 1%
MD_GRAD_REL, MD_GRAD_REL_ALL = 5e-2, 1e-2

# the Shallow2Deep recipe (phase 16; torch-em's 2-D Shallow2Deep enhancers, BASELINE.md:10): 4 forests of 10 trees on
# the default filter bank, fitted on the card's host by scripts/torch_s2d_forests.py's recipe from its seed-0 images
# (sklearn fitted the committed .npz by the same recipe); the
# enhancer UNet2d(1 -> 1, depth 4, f=64, Sigmoid) on their foreground probabilities, 256x256 patches, batch 8, bf16,
# DiceLoss, AdamW 1e-4, 8 iterations and 2 more after from_checkpoint; the enhancer's float32 forward on the card
# against the CPU (TF32 off) and the torchscript weights against the state-dict model within 1e-4
S2D_SEED = 0
S2D_MODEL = dict(in_channels=1, out_channels=1, initial_features=64, final_activation="Sigmoid")
S2D_DEPTH, S2D_BATCH, S2D_PATCH, S2D_FIT, S2D_RESUME = 4, 8, (1, 256, 256), 8, 2
S2D_CPU_ATOL, S2D_HOST_PATCHES, S2D_MEDICAL, S2D_LOADER_STEPS = 1e-4, 8, (24, 64, 64), 4
# 16c: the advanced path's stages, forests per stage and the share of a patch's pixels a later stage samples
S2D_STAGES, S2D_PER_STAGE, S2D_FRACTION = 2, 2, 0.5
# Shallow2DeepModel's enhancer on the two 512x512 test images at once, in float32
S2D_PREDICT = (2, (512, 512))

# the dataset zoo's EM readers (phase 17). 17a: the CREMI recipe's tracked model (experiments/cremi/train_cremi.py)
# through get_benchmark_loader on MitoLab benchmark 5 (Lucchi++) at its published shape, its layout written as two
# multi-page TIFFs that tile a seeded block of EM_BLOCK; labels_to_binary targets, the zoo's default augmentations,
# 32x256x256, batch 1. 17b: UNet2d(1 -> 1, f=64, Sigmoid) through get_mitolab_loader on EM_MITO_IMAGES seeded 224x224
# TIFF pairs in CEM-MitoLab's layout, batch 8. Each fits EM_FIT iterations and EM_RESUME more after from_checkpoint;
# the first EM_CHECK_SAMPLES samples of each zoo dataset equal those of a dataset over the same arrays in memory
EM_BENCHMARK_ID, EM_BLOCK = 5, (33, 256, 256)
EM_MITO_IMAGES, EM_MITO_DATASETS, EM_MITO_BASE = 256, 4, 16
EM_2D_MODEL = dict(in_channels=1, out_channels=1, initial_features=64, final_activation="Sigmoid")
EM_2D_PATCH, EM_2D_BATCH = (224, 224), 8
EM_FIT, EM_RESUME, EM_CHECK_SAMPLES, EM_LOADER_STEPS = 8, 2, 4, 6

# the dataset zoo's light-microscopy readers (phase 18). 18a: the DSB recipe (experiments/dsb/train_dsb.py) through
# get_dsb_loader on the layout get_dsb_data leaves of StarDist's dsb2018 "reduced" source, at its published count of
# LM_DSB_IMAGES (train, test) seeded LM_DSB_SHAPE images (uint8 raw, uint16 instance masks, TIFF), boundaries, batch
# DSB_BATCH, 4 thread workers, bf16; and one batch of the SPOCO recipe's loader (connected components, int32). 18b: the
# ViM-UNet / UNETR recipe's UNETR (experiments/vimunet/train_vimunet_livecell.py --model unetr) through
# get_livecell_loader on LIVECell's layout: LM_LIVECELL_IMAGES (train, val) 704x520 uint8 TIFFs (of the published
# 3253 and 570) under images/livecell_train_val_images/<cell type>/, their cells as COCO polygons in train.json and
# val.json, about LM_LIVECELL_CELLS per image (1 686 352 cells over 5 239 images in LIVECell's paper), converted on
# first use. Each fits LM_FIT iterations and LM_RESUME more after from_checkpoint
LM_DSB_IMAGES, LM_DSB_SHAPE = (447, 50), (256, 256)
LM_LIVECELL_IMAGES, LM_LIVECELL_CELLS, LM_LIVECELL_SHAPE = (64, 16), 320, (520, 704)
LM_LIVECELL_PATCH = (512, 512)
LM_FIT, LM_RESUME, LM_LOADER_STEPS = 8, 2, 8

# the dataset zoo's histopathology and medical readers (phase 19); each fits LM_FIT iterations and LM_RESUME more after
# from_checkpoint. 19a: UNet2d(3 -> 2, f=64, Sigmoid), the DSB recipe's model on H&E input (the repo records no
# histopathology recipe), through get_monuseg_loader with boundaries on MoNuSeg's extracted layout: HP_MONUSEG_IMAGES
# (train, test) seeded 1000x1000 RGB TIFFs (of the published 30 and 14), each with an Aperio XML of HP_MONUSEG_NUCLEI
# polygons (21 623 nuclei over the 30 training images, about 720 an image), rasterized on first use; batch DSB_BATCH of
# HP_PATCH. 19b: UNet3d(1 -> 16, f=32, Sigmoid) through get_amos_loader(modality="CT") on OneHotTransform(16) targets
# (15 organs and background) on AMOS' layout: MED_AMOS_VOLUMES (train, val) seeded CT volumes (ids under 500; of the
# published 200 and 100) written with medical_io.save_nifti, int16 Hounsfield-like values, 512x512 in plane and
# MED_AMOS_SHAPE[2] slices, in load_nifti's (X, Y, Z) order, each a seeded tile of 15 organs repeated (every patch holds
# every class); batch MED_BATCH of MED_PATCH, in the same order
HP_MONUSEG_IMAGES, HP_MONUSEG_SHAPE, HP_MONUSEG_NUCLEI = (8, 2), (1000, 1000), 720
HP_MODEL = dict(in_channels=3, out_channels=2, initial_features=64, final_activation="Sigmoid")
HP_PATCH = (512, 512)
MED_AMOS_VOLUMES, MED_AMOS_SHAPE, MED_AMOS_CLASSES = (4, 2), (512, 512, 128), 16
MED_MODEL = dict(in_channels=1, out_channels=MED_AMOS_CLASSES, initial_features=32, final_activation="Sigmoid")
MED_DEPTH, MED_BATCH, MED_PATCH = 4, 2, (128, 128, 64)

# the quality probes' paths (phase 20), through the functions of scripts/torch_parity2d.py and
# scripts/torch_parity3d.py, QP_FIT iterations each: 20a the DSB probe (UNet2d f=16, batch 4 of 128x128) on its whole
# data, its labels checked against the tracked files' sha256; 20b the tracked DSB (f=64, batch 8 of 256x256) on the
# first QP_DSB_IMAGES (train, val) images (32 train images make 4 steps an epoch: each epoch writes a checkpoint of
# 375 MB, and 8 images, one step an epoch, took 32 s of the phase on the card); 20c the tracked CREMI model on one train
# and one val volume of 40x320x320, the boundary target on the card. The full runs are the scripts'. The DSB probe's
# model and batch are the script's (phase 20 checks them), for the norm rows of phases 3 and 5
QP_FIT, QP_DSB_IMAGES, QP_CREMI_VOLUMES = 20, (32, 4), (1, 1)
DSB_PROBE_FEATURES, DSB_PROBE_BATCH, DSB_PROBE_PATCH = 16, 4, (128, 128)
# 20d the SPOCO probe (scripts/torch_spoco2d.py: the DSB probe's images and rows, f=16, batch 4 of 128x128, float32)
# and 20e the SNEMI probe (scripts/torch_parity3d.py --mode affinity); all five under the scripts' --deterministic
# settings;
# the SNEMI probe's model, batch and patch are the script's (phase 20 checks them), for the rows of phases 3 and 5
SNEMI_PROBE_FEATURES, SNEMI_PROBE_SCALES, SNEMI_PROBE_PATCH = 8, [[1, 2, 2], [2, 2, 2]], (8, 64, 64)
SNEMI_PROBE_NORMS = 10  # 2 a ConvBlock: 2 encoder levels, the base, 2 decoder levels
# the SNEMI probe's masked Dice over 7 channels of one random patch a step falls by about 0.5 in 150 steps at lr 1e-4
# (0.1 per epoch of 50) and moves by more than that from patch to patch: 20e trains 3 epochs and compares the means of
# the first and the last fifth of its losses
QP_SNEMI_FIT = 150
# the scripts' evaluation batch of the DSB images (phase 3 holds the forward at batch 4 of the f=64 rows)
QP_EVAL_BATCH = 4

# HDF5 on the card (phase 22): bench.py's loader volume and chunks; the tracked model trained H5_FIT steps and resumed
# for H5_RESUME from it (bench.py's random labels teach nothing, so the loss need not fall); H5_WINDOWS random
# windows of TRAIN_PATCH time the reader; the 3-D probe model H5_PROBE_FIT + H5_PROBE_RESUME steps over the tracked
# parity volumes; LZF tiles grown along an unlimited axis as histopathology/orion_crc.py writes them
H5_VOLUME, H5_CHUNKS = (64, 512, 512), (32, 128, 128)
H5_FIT, H5_RESUME, H5_WINDOWS = 8, 2, 6
H5_PROBE_FIT, H5_PROBE_RESUME = 4, 2
H5_LZF_TILES, H5_LZF_TILE = 12, (256, 256)
H5_PARITY_FILES = 12
# zarr and N5 on the card (phase 23): phase 22's volume, chunks, windows and step counts; ZN_PROCESS_BATCHES batches of
# the N5 volume through ZN_PROCESS_WORKERS process workers; the CLI's prediction of a TRAIN_PATCH crop written to N5 in
# ZN_PRED_CHUNKS; the zoo's platynereis cells (ZN_PLATY_FILES N5 volumes of ZN_PLATY_VOLUME) and TissueNet
# (ZN_TISSUENET train and val images of ZN_TISSUENET_SIDE², through its own zarr conversion), each ZN_ZOO_FIT steps
# and ZN_ZOO_RESUME more after from_checkpoint
ZN_PROCESS_BATCHES, ZN_PROCESS_WORKERS = 3, 2
ZN_PRED_CHUNKS, ZN_MIN_DIVISIBLE = (16, 128, 128), (4, 16, 16)
ZN_PLATY_FILES, ZN_PLATY_VOLUME = 9, (40, 320, 320)
ZN_TISSUENET, ZN_TISSUENET_SIDE = (8, 2), 512
ZN_ZOO_FIT, ZN_ZOO_RESUME = 4, 2
ZN_BLOCKED = ("tensorstore", "zarr", "h5py")
# training logs and HDBSCAN on the card (phase 24), with tensorboardX, tensorboard, sklearn and matplotlib blocked:
# 24a the tracked model through default_segmentation_trainer with its default logger (no logger argument), LOG_FIT
# steps and LOG_RESUME more after from_checkpoint at log_image_interval LOG_IMAGES, beside the same fits with
# logger=None in turns (LOG_PAIRS of each), then fits as long as the default log_image_interval, at it, in turns
# against logger=None (LOG_PAIRS of each); 24b SPOCOTrainer (the SPOCO recipe), MeanTeacherTrainer (unsupervised, DSB
# width) and default_classification_trainer (resnet3d_50) with their default loggers, LOG_ST_FIT + LOG_ST_RESUME
# steps each; 24c the committed sklearn fixtures of scripts/make_hdbscan_fixtures.py, then HDBScanRandMetric on
# 24b's SPOCO embeddings of HDBSCAN_CROPS DSB crops of HDBSCAN_CROP (16384 points of 8 dimensions each; min_size
# below the smallest nucleus of the DSB images, 113 pixels, eps as the metric tests take it)
LOG_FIT, LOG_RESUME, LOG_IMAGES, LOG_PAIRS = 8, 2, 4, 2
LOG_ST_FIT, LOG_ST_RESUME = 2, 1
LOG_BLOCKED = ("tensorboardX", "tensorboard", "sklearn", "matplotlib")
HDBSCAN_CROP, HDBSCAN_CROPS, HDBSCAN_METRIC = (128, 128), 2, dict(min_size=50, eps=0.2)
# the loader rates of one run, for phase 22's comparison with phase 7's .npy loader
LOADER_RATES = {}
# the zoo's conversions with no optional package (phase 25), with pydicom, nibabel, imageio, pycocotools, geopandas,
# rasterio and shapely blocked: 25a 3D-IRCADb's layout, one DICOM file a slice, CONV_IRCADB_PATIENTS (train, val)
# patients of CONV_CT_SHAPE int16 CT (BitsStored 12) with a uint8 liver mask series, in explicit VR LE (masks
# deflated), implicit VR LE and RLE Lossless, converted by get_ircadb_loader and trained into phase 19b's UNet3d with
# one output (bf16) on CONV_IRCADB_PATCH in the h5's (Z, Y, X) order; 25b PUMA's layout, CONV_PUMA_ROIS 1024x1024
# RGBA TIFFs with CONV_PUMA_NUCLEI GeoJSON nuclei each, rasterized on first use, into UNet2d at DSB width (phase 19a's
# model, batch and patch); each CONV_FIT steps and CONV_RESUME more after from_checkpoint. 25c: OrgLine's COCO
# masks (CONV_ORGLINE_IMAGES stomach and breast images of CONV_ORGLINE_SHAPE), UroCell's NIfTI volumes
# (CONV_URO_SHAPE), write_data's images, Parhyale's hyperstack (50 time points of CONV_PARHYALE_STACK) and HEST's
# CellViT and Xenium nuclei (CONV_HEST_NUCLEI a slide of 2x2 patches), each held against what was written
CONV_BLOCKED = ("pydicom", "nibabel", "imageio", "pycocotools", "geopandas", "rasterio", "shapely")
CONV_CT_SHAPE, CONV_IRCADB_PATIENTS, CONV_IRCADB_PATCH = (96, 512, 512), (2, 1), (64, 128, 128)
CONV_PUMA_ROIS, CONV_PUMA_NUCLEI = 4, 300
CONV_FIT, CONV_RESUME = 4, 2
CONV_ORGLINE_IMAGES, CONV_ORGLINE_SHAPE = (4, 2), (192, 256)
CONV_URO_SHAPE, CONV_PARHYALE_STACK, CONV_HEST_NUCLEI = (48, 96, 80), (3, 64, 64), 150
# phases 8 to 21 but 15, 24 and 25 run at the same time in these groups of one child process each, about equal in
# length (phase 12 with 14: they train on the same images, and their card memory peaks near 32 and 28 GiB; phase 15,
# whose two ranks hold 25 GiB each, runs alone before them); a group ends within FANOUT_DEADLINE s of the start of
# the run or is stopped
FANOUT = ((12, 14), (8, 16, 19, 21), (9, 10, 11, 13, 25), (17, 18, 20, 24))
FANOUT_DEADLINE = 1100

# device kernels of the profiler breakdowns: the port's norms, cuDNN's convs
NORM_KERNELS = re.compile(r"row_in_registers|row_in_cluster|row_through_l2")
CONV_KERNELS = re.compile(r"conv|cudnn|xmma|implicit_gemm|dgrad|wgrad|fprop|nchw|nhwc", re.I)


def log(msg):
    print(f"[smoke +{time.perf_counter() - T0:.1f}s] {msg}", flush=True)


def nvidia_smi():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def widths(initial_features, depth, gain=2):
    """A U-Net factory's encoder widths: ``initial_features * gain ** level``."""
    return [initial_features * gain ** i for i in range(depth)]


def norm_shapes(block, scale_factors, feats, in_channels=1, gain=2):
    """(channels, spatial shape) of the instance norms of one U-Net forward, in order; ``feats``
    are the encoder's widths, one per level, and the base has ``gain`` times the last."""
    shapes, skips, sp, cin = [], [], tuple(block), in_channels
    for f, sf in zip(feats, scale_factors):
        shapes += [(cin, sp), (f, sp)]
        skips.append(sp)
        sp, cin = tuple(s // k for s, k in zip(sp, sf)), f
    shapes += [(cin, sp), (feats[-1] * gain, sp)]
    for f, skip in zip(feats[::-1], skips[::-1]):
        shapes += [(2 * f, skip), (f, skip)]
    return shapes


def unetr_norm_shapes(embed_dim, skip, size=512, initial_features=64, depth=3, in_chans=3, grid=None):
    """(channels, spatial shape) of the instance norms of one UNETR (or ViM-UNet) forward at a
    ``size`` x ``size`` input (after ``resize_input``), in order: the input's ConvBlock (``skip``
    only), the base at the encoder's ``grid`` (size / 16 when None), the decoder's levels, the
    head at 16 x grid."""
    feats = [initial_features * 2 ** i for i in range(depth + 1)][::-1]
    sp = grid or size // 16
    shapes = [(in_chans, (size, size)), (feats[-1], (size, size))] if skip else []
    shapes += [(embed_dim, (sp, sp)), (feats[0], (sp, sp))]
    for f in feats[1:]:
        sp *= 2
        shapes += [(2 * f, (sp, sp)), (f, (sp, sp))]
    return shapes + [(2 * feats[-1], (2 * sp, 2 * sp)), (feats[-1], (2 * sp, 2 * sp))]


def path_of(inorm, shape, dtype, direction):
    """The kernel path (A, B or C) of a (channels, spatial) norm of batch 1."""
    c, sp = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return inorm.plan(c, int(np.prod(sp)), itemsize, direction, sms).path


def path_counts(inorm, shapes, dtype, direction):
    counts = {"A": 0, "B": 0, "C": 0}
    for shape in shapes:
        counts[path_of(inorm, shape, dtype, direction)] += 1
    return counts


def time_ms(fn, *args, iters=5, repeats=5):
    """Time of ``fn(*args)`` as called: the median over ``repeats`` runs of the mean of
    ``iters`` back-to-back calls between CUDA events, after one warm-up call. At small
    shapes the host's launch rate sets it, and the host is noisy."""
    fn(*args)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn(*args)
        stop.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(stop) / iters)
    return float(np.median(runs))


def profiled_kernels(fn, steps):
    """{kernel name: device ms per step} of ``steps`` calls of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        # kernels and copies; not the annotations that span them (e.g. "Optimizer.step")
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
            out[e.key] = out.get(e.key, 0.0) + us / 1e3 / steps
    return out


def device_ms(fn, *args):
    """Device time of one call of ``fn(*args)``, host excluded: one replay of a CUDA graph
    that captured GRAPH_CALLS calls, over GRAPH_CALLS."""
    fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn(*args)
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / GRAPH_CALLS


def device_breakdown(label, fn, steps=3, top=8):
    """Log the top device kernels of ``fn`` by time, and the norms' and convs' shares."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) / steps * 1e3
    kernels = profiled_kernels(fn, steps)
    total = sum(kernels.values())
    if total == 0:
        raise AssertionError(f"{label}: the profiler shows no device time")
    norms = sum(ms for k, ms in kernels.items() if NORM_KERNELS.search(k))
    convs = sum(ms for k, ms in kernels.items() if CONV_KERNELS.search(k) and not NORM_KERNELS.search(k))
    log(f"{label}: {total:.3f} ms of device kernels per call under the profiler, {wall:.3f} ms "
        f"wall per call without it (device idle {max(0.0, 1 - total / wall):.1%}); norms {norms:.3f} ms "
        f"({norms / total:.1%}), convs (cuDNN) {convs:.3f} ms ({convs / total:.1%}), other "
        f"{total - norms - convs:.3f} ms ({(total - norms - convs) / total:.1%})")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:top]:
        log(f"    {ms:8.3f} ms {ms / total:6.1%}  {name[:110]}")
    return {"device_ms": total, "norm_ms": norms, "conv_ms": convs, "kernels": kernels,
            "idle": max(0.0, 1 - total / wall)}


def card_generator(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def card_rand(gen, shape, dtype, offset=0):
    """Seeded normal(0.5, 2) values on the card; ``offset`` elements shift the base address."""
    n = int(np.prod(shape))
    buf = (torch.randn(n + offset, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    return buf[offset:].view(shape)


def output_tol(ref, dtype):
    if dtype == torch.float32:
        return torch.full_like(ref, F32_ATOL)
    if dtype == torch.bfloat16:
        return BF16_RTOL * ref.abs() + BF16_ATOL
    return F16_RTOL * ref.abs() + F16_RTOL_OF_MAX * ref.abs().max()


def check_kernel(kernel, plain, x):
    """Max abs error of kernel against plain version; raises past the tolerance."""
    y = kernel(x).float()
    ref = plain(x).float()
    torch.cuda.synchronize()
    err = (y - ref).abs()
    if not bool(torch.isfinite(y).all()) or bool((err > output_tol(ref, x.dtype)).any()):
        raise AssertionError(f"kernel disagrees at {tuple(x.shape)} {x.dtype}: "
                             f"max abs err {float(err.max())}")
    return float(err.max())


def layout_cases(rand, dtype):
    """Inputs beside the main path's: ragged, odd-length, misaligned, strided, channels-last."""
    cases = [rand(s, dtype) for s in ((2, 3, 5, 7, 11), (1, 1, 3 * 16384 + 5), (1, 2, 40, 577, 577),
                                      (3, 4, 16))]
    for shape in ((1, 2, 1000), (1, 2, 65536)):  # base addresses off the 16-byte grid
        cases.append(rand(shape, dtype, offset=1))
        assert cases[-1].data_ptr() % 16 != 0
    cases.append(rand((1, 64, 8, 64, 64), dtype)[:, ::2])
    cases.append(rand((1, 32, 16, 64, 64), dtype).to(memory_format=torch.channels_last_3d))
    assert not cases[-1].is_contiguous() and not cases[-2].is_contiguous()
    return cases


def repeat_shapes(inorm, shapes, direction):
    """One main-path shape per kernel path (bf16), for the bitwise-repeat check."""
    found = {}
    for shape in shapes:
        found.setdefault(path_of(inorm, shape, torch.bfloat16, direction), shape)
    assert sorted(found) == ["A", "B", "C"], found
    return found


def dsb_paths(inorm, dsb_shapes, dtype, direction):
    """{path: (channels, spatial)} of the DSB step's norms (batch DSB_BATCH), first shape per path."""
    found = {}
    for c, sp in dsb_shapes:
        found.setdefault(path_of(inorm, (DSB_BATCH * c, sp), dtype, direction), (c, sp))
    return found


def check_rows(err_of, x, *rest, rows=8):
    """``err_of(x, *rest)`` over groups of ``rows`` channels: the plain versions' temporaries of a
    slab's level-0 norms (up to 64 x 35.6 M elements) would not fit beside the kernel's in one piece;
    each channel's row is independent of the others."""
    return max(err_of(*(t[:, c:c + rows] for t in (x, *rest))) for c in range(0, x.shape[1], rows))


def check_sharded_forward(inorm, rand, sharded_shapes, dtype):
    """The forward kernel at the sharded paths' shapes (a whole row per channel at once, checked
    against the plain version channel group by channel group); returns the max abs error."""
    max_err = 0.0
    for name, shapes in sharded_shapes.items():
        for c, sp in sorted(set(shapes)):
            x = rand((1, c) + sp, dtype)
            y = inorm.instance_norm(x)

            def err_of(xc, yc):
                ref = inorm.instance_norm_reference(xc).float()
                err = (yc.float() - ref).abs()
                if not bool(torch.isfinite(yc).all()) or bool((err > output_tol(ref, dtype)).any()):
                    raise AssertionError(f"kernel disagrees at {tuple(x.shape)} {dtype}: max abs err {float(err.max())}")
                return float(err.max())

            err = check_rows(err_of, x, y)
            max_err = max(max_err, err)
            log(f"  norm {dtype} {name} C={c} {sp} ({x.numel()} elements) path "
                f"{path_of(inorm, (c, sp), dtype, 'forward')}: max abs err {err:.3g}")
            del x, y
    torch.cuda.empty_cache()
    return max_err


def check_sharded_backward(inorm, rand, shapes, dtype):
    """The backward kernel at the spatial step's shapes, checked channel group by channel group."""
    max_err = 0.0
    for c, sp in sorted(set(shapes)):
        x, g = rand((1, c) + sp, dtype), rand((1, c) + sp, dtype)
        _, mean, rstd = inorm.instance_norm_forward(x)
        dx = inorm.instance_norm_backward(x, g, mean, rstd)

        def err_of(xc, gc, dxc, mc, rc):
            ref = inorm.instance_norm_backward_reference(xc, gc, mc, rc).float()
            scale = float(ref.abs().max())
            if dtype == torch.float32:
                tol = BWD_F32_RTOL_OF_MAX * scale
            else:
                tol = (BWD_BF16_RTOL if dtype == torch.bfloat16 else BWD_F16_RTOL) * ref.abs() + \
                    BWD_BF16_RTOL_OF_MAX * scale
            err = (dxc.float() - ref).abs()
            if not bool(torch.isfinite(dxc).all()) or bool((err > tol).any()):
                raise AssertionError(f"backward kernel disagrees at {tuple(x.shape)} {dtype}: "
                                     f"max abs err {float(err.max())}")
            return float(err.max())

        # the statistics by channel group too: (1, C) -> (1, rows)
        err = check_rows(err_of, x, g, dx, mean, rstd)
        max_err = max(max_err, err)
        log(f"  backward {dtype} spatial_training C={c} {sp} path {path_of(inorm, (c, sp), dtype, 'backward')}: "
            f"max abs err {err:.3g}")
        del x, g, dx
    torch.cuda.empty_cache()
    return max_err


def time_large_norm(inorm, x, label, backward=False):
    """Times at one of the sharded paths' level-0 shapes, as called (a CUDA graph of these
    calls would hold GRAPH_CALLS outputs of up to 4.6 GB): kernel, plain version,
    F.instance_norm, and the byte bound; with ``backward``, the backward's too."""
    F = torch.nn.functional
    size = x.numel() * x.element_size()
    t = {"forward": {"ms": time_ms(inorm.instance_norm, x, iters=3, repeats=3),
                     "plain_ms": time_ms(inorm.instance_norm_reference, x, iters=1, repeats=3),
                     "library_ms": time_ms(F.instance_norm, x, iters=3, repeats=3),
                     "bound_ms": 2 * size / HBM_BYTES_PER_S * 1e3}}
    if backward:
        g = torch.randn_like(x)
        _, mean, rstd = inorm.instance_norm_forward(x)
        xr = x.detach().requires_grad_()
        yr = F.instance_norm(xr)
        t["backward"] = {"ms": time_ms(inorm.instance_norm_backward, x, g, mean, rstd, iters=3, repeats=3),
                         "plain_ms": time_ms(inorm.instance_norm_backward_reference, x, g, mean, rstd, iters=1,
                                             repeats=3),
                         "library_ms": time_ms(lambda: torch.autograd.grad(yr, xr, g, retain_graph=True), iters=3,
                                               repeats=3),
                         "bound_ms": 3 * size / HBM_BYTES_PER_S * 1e3}
        del g, mean, rstd, xr, yr
    for direction, v in t.items():
        path = path_of(inorm, (x.shape[1], tuple(x.shape[2:])), x.dtype, direction)
        log(f"  time {x.dtype} {label} {direction} path {path}: kernel {v['ms']:.4f} ms as called; plain "
            f"{v['plain_ms']:.4f} ms; F.instance_norm {v['library_ms']:.4f} ms; bound {v['bound_ms']:.4f} ms")
    torch.cuda.empty_cache()
    return t


def phase_norm_kernel(inorm, shapes, train_shapes, dsb_shapes, snemi_shapes, spoco_shapes, vit_shapes, st_shapes,
                      sharded_shapes, predict_shapes):
    """Check the forward kernel at every main-path shape (the DSB and SPOCO steps' at batch
    DSB_BATCH, the SNEMI recipe's serving and validation blocks, ``snemi_shapes`` {name:
    shapes}, the UNETR and ViM-UNet decoders' at training batch VIT_BATCH and serving batch
    1, ``vit_shapes`` {name: (training batch, shapes)}, the self-training steps' and the MitoLab step's,
    ``st_shapes`` {name: (batch, shapes)}, the sharded paths' slabs with their halo, ``sharded_shapes`` {name: shapes}, and the inference
    batches of ``predict_shapes`` {name: (batch, shapes)}) and time it at the serving path's and at the slabs'
    level-0 rows; returns its entry of the kernels line."""
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(shape, dtype, offset=0):
        return card_rand(g, shape, dtype, offset)

    max_err = 0.0
    for dtype in DTYPES:
        hit = set()
        for c, sp in sorted(set(shapes).union(train_shapes, *snemi_shapes.values())):
            err = check_kernel(inorm.instance_norm, inorm.instance_norm_reference,
                               rand((1, c) + sp, dtype))
            max_err = max(max_err, err)
            hit.add(path_of(inorm, (c, sp), dtype, "forward"))
            log(f"  norm {dtype} C={c} {sp} path {path_of(inorm, (c, sp), dtype, 'forward')}: "
                f"max abs err {err:.3g}")
        assert hit == {"A", "B", "C"}, hit
        for x in layout_cases(rand, dtype):
            max_err = max(max_err, check_kernel(inorm.instance_norm, inorm.instance_norm_reference, x))
        log(f"  norm {dtype}: ragged, odd-length, misaligned, strided and channels-last inputs agree")
        for recipe, batch, batch_shapes in (("DSB", DSB_BATCH, dsb_shapes), ("SPOCO", DSB_BATCH, spoco_shapes),
                                            *((name, b, s) for name, (b, s) in st_shapes.items())):
            for c, sp in sorted(set(batch_shapes)):
                err = check_kernel(inorm.instance_norm, inorm.instance_norm_reference, rand((batch, c) + sp, dtype))
                max_err = max(max_err, err)
                log(f"  norm {dtype} {recipe} ({batch}, {c}) {sp} path "
                    f"{path_of(inorm, (batch * c, sp), dtype, 'forward')}: max abs err {err:.3g}")
        seen = set()
        for recipe, (train_batch, recipe_shapes) in vit_shapes.items():
            for batch in (train_batch, 1):
                for c, sp in sorted(set(recipe_shapes) - seen):
                    err = check_kernel(inorm.instance_norm, inorm.instance_norm_reference,
                                       rand((batch, c) + sp, dtype))
                    max_err = max(max_err, err)
                    log(f"  norm {dtype} {recipe} ({batch}, {c}) {sp} path "
                        f"{path_of(inorm, (batch * c, sp), dtype, 'forward')}: max abs err {err:.3g}")
            seen.update(recipe_shapes)
        for name, (batch, batch_shapes) in predict_shapes.items():
            for c, sp in sorted(set(batch_shapes)):
                err = check_kernel(inorm.instance_norm, inorm.instance_norm_reference, rand((batch, c) + sp, dtype))
                max_err = max(max_err, err)
                log(f"  norm {dtype} {name} ({batch}, {c}) {sp} path "
                    f"{path_of(inorm, (batch * c, sp), dtype, 'forward')}: max abs err {err:.3g}")
        max_err = max(max_err, check_sharded_forward(inorm, rand, sharded_shapes, dtype))
    repeats = [((1, c) + sp, path) for path, (c, sp) in repeat_shapes(inorm, shapes, "forward").items()]
    repeats += [((DSB_BATCH, c) + sp, f"{path} (DSB)")
                for path, (c, sp) in dsb_paths(inorm, dsb_shapes, torch.bfloat16, "forward").items()]
    for shape, path in repeats:
        x = rand(shape, torch.bfloat16)
        first, second = inorm.instance_norm_forward(x), inorm.instance_norm_forward(x)
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"forward kernel path {path} is not bitwise repeatable")
    log(f"kernel agrees with instance_norm_reference: max abs err {max_err:.3g} "
        f"(f32 atol {F32_ATOL}; bf16 {BF16_RTOL:.3g}*|ref| + {BF16_ATOL}; f16 {F16_RTOL:.3g}*|ref| "
        f"+ {F16_RTOL_OF_MAX}*max|ref|); two calls bitwise equal on paths {[p for _, p in repeats]}")

    totals = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
              "library_device_ms": 0.0}
    for c, sp in sorted(set(shapes)):
        x = rand((1, c) + sp, torch.bfloat16)
        count = shapes.count((c, sp))
        t = time_norm(inorm, x, f"C={c} {sp} x{count}")
        for key in totals:
            totals[key] += count * t[key]
        del x
    for c, sp in sorted(repeat_shapes(inorm, shapes, "forward").values()):
        time_norm(inorm, rand((1, c) + sp, torch.float16), f"C={c} {sp}")
    torch.cuda.empty_cache()
    level0 = {f"{name} C={c} {sp}": time_large_norm(inorm, rand((1, c) + sp, torch.bfloat16), name)["forward"]
              for name, s in sharded_shapes.items() for c, sp in sorted(set(s)) if sp == s[0][1]}
    log(f"per serving forward ({len(shapes)} norms, bf16): kernel {totals['ms']:.3f} ms as called, "
        f"{totals['device_ms']:.3f} ms device; plain {totals['plain_ms']:.3f} ms, F.instance_norm "
        f"{totals['library_ms']:.3f} ms as called, {totals['library_device_ms']:.3f} ms device; "
        f"bound {totals['bound_ms']:.3f} ms")
    return {
        "name": "instance_norm",
        "route": "cuda",
        "source": "torch_em_tpu_torch/ops/csrc/instance_norm.cu",
        "replaces": "torch_em_tpu/ops/pallas/norm.py:83",
        "launches": None,
        "max_abs_err": max_err,
        "ms": totals["ms"],
        "device_ms": totals["device_ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": "bytes",
        "library_ms": totals["library_ms"],
        "paths": {"serving": path_counts(inorm, shapes, torch.bfloat16, "forward"),
                  "training": path_counts(inorm, train_shapes, torch.bfloat16, "forward"),
                  "dsb_training": path_counts(inorm, [(DSB_BATCH * c, sp) for c, sp in dsb_shapes],
                                              torch.bfloat16, "forward"),
                  "spoco_training": path_counts(inorm, [(DSB_BATCH * c, sp) for c, sp in spoco_shapes],
                                                torch.bfloat16, "forward"),
                  **{name: path_counts(inorm, s, torch.bfloat16, "forward") for name, s in snemi_shapes.items()},
                  **{f"{name}_training": path_counts(inorm, [(b * c, sp) for c, sp in s], torch.bfloat16,
                                                     "forward") for name, (b, s) in vit_shapes.items()},
                  **{f"{name}_serving": path_counts(inorm, s, torch.bfloat16, "forward")
                     for name, (b, s) in vit_shapes.items()},
                  **{f"{name}_training": path_counts(inorm, [(b * c, sp) for c, sp in s], torch.bfloat16, "forward")
                     for name, (b, s) in st_shapes.items()},
                  **{name: path_counts(inorm, s, torch.bfloat16, "forward") for name, s in sharded_shapes.items()},
                  **{f"{name}_float32": path_counts(inorm, [(b * c, sp) for c, sp in s], torch.float32, "forward")
                     for name, (b, s) in predict_shapes.items()}},
        "sharded_level0": level0,
    }


def time_norm(inorm, x, label):
    """Forward times at one shape: kernel as called and device-only, plain version,
    F.instance_norm as called and device-only, and the byte bound."""
    t = {"ms": time_ms(inorm.instance_norm, x), "device_ms": device_ms(inorm.instance_norm, x),
         "plain_ms": time_ms(inorm.instance_norm_reference, x),
         "library_ms": time_ms(torch.nn.functional.instance_norm, x),
         "library_device_ms": device_ms(torch.nn.functional.instance_norm, x),
         "bound_ms": 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3}
    y = torch.empty_like(x)
    copy_ms = device_ms(y.copy_, x)  # the same bytes moved by a plain copy: a practical bound
    path = path_of(inorm, (x.shape[1], tuple(x.shape[2:])), x.dtype, "forward")
    log(f"  time {x.dtype} {label} path {path}: kernel {t['ms']:.4f} ms as called, "
        f"{t['device_ms']:.4f} ms device; plain {t['plain_ms']:.4f} ms; F.instance_norm "
        f"{t['library_ms']:.4f} ms as called, {t['library_device_ms']:.4f} ms device; "
        f"bound {t['bound_ms']:.4f} ms, copy_ {copy_ms:.4f} ms device")
    return t


class TimedModel(torch.nn.Module):
    """The model, with a pair of CUDA events around each forward."""

    def __init__(self, model):
        super().__init__()
        self.model = model
        self.out_channels = model.out_channels
        self.events = []

    def forward(self, x):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.model(x)
        stop.record()
        self.events.append((start, stop))
        return out

    def device_ms(self):
        torch.cuda.synchronize()
        return sum(start.elapsed_time(stop) for start, stop in self.events)


def serve(port, inorm, model, volume, path, runs=2, block_shape=BLOCK_SHAPE, halo=HALO, norms=NORMS_PER_FORWARD):
    """``predict_with_halo`` on ``volume`` through the host path (``path`` "host": the numpy
    volume) or the device-resident one ("device": a copy on the card, made before the
    call), in blocks of ``block_shape`` with ``halo``; the last of ``runs`` calls is timed, the
    first pays for cuDNN's first calls.

    Returns the output as a float32 numpy array and the timed call's numbers: wall time,
    Mvox/s, ms per block, the forwards' device time (CUDA events around each), the
    device's idle share (the wall time outside the forwards) and the norm kernel's
    launches, counted from 0 just before the call."""
    timed = TimedModel(model)
    x = volume if path == "host" else torch.from_numpy(volume).cuda()
    n_blocks = port.Blocking([0] * volume.ndim, volume.shape, block_shape).n_blocks
    for _ in range(runs):
        timed.events.clear()
        torch.cuda.synchronize()
        inorm.instance_norm.launches = 0
        t = time.perf_counter()
        out = port.predict_with_halo(x, timed, block_shape=block_shape, halo=halo, output_dtype="float16")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = inorm.instance_norm.launches
    forward_ms = timed.device_ms()
    if path == "device":
        if not (isinstance(out, torch.Tensor) and out.device == x.device and out.dtype == torch.float16):
            raise AssertionError(f"the device-resident path returned {type(out)}")
        out = out.float().cpu().numpy()
    del x
    stats = {"path": path, "volume": list(volume.shape), "blocks": n_blocks, "seconds": seconds,
             "mvox_per_s": volume.size / seconds / 1e6, "ms_per_block": seconds / n_blocks * 1e3,
             "forward_device_ms": forward_ms, "device_idle": max(0.0, 1 - forward_ms / (seconds * 1e3)),
             "launches": launches}
    log(f"{path} path {volume.shape}: {stats['mvox_per_s']:.2f} Mvox/s, {stats['ms_per_block']:.1f} ms "
        f"per block ({seconds:.3f} s for {n_blocks} blocks); forwards {forward_ms:.1f} ms device "
        f"({forward_ms / n_blocks:.2f} ms per block), device idle {stats['device_idle']:.1%} of the call; "
        f"{launches} norm launches")
    if out.shape != (model.out_channels,) + volume.shape:
        raise AssertionError(f"output shape {out.shape}")
    if not np.isfinite(out).all() or out.min() < 0 or out.max() > 1:
        raise AssertionError("output is not finite or leaves [0, 1]")
    if launches != norms * n_blocks:
        raise AssertionError(f"{launches} kernel launches, expected {norms} x {n_blocks} blocks")
    return out, stats


def serial_predict(port, model, volume):
    """A plain serial block loop: each block loaded and standardized on the host, then
    predicted alone and cast to float16 on the card."""
    blocking = port.Blocking([0] * volume.ndim, volume.shape, BLOCK_SHAPE)
    out = np.zeros((1,) + volume.shape, dtype=np.float32)
    inner = tuple(slice(h, h + b) for h, b in zip(HALO, BLOCK_SHAPE))
    with torch.inference_mode():
        for block_id in range(blocking.n_blocks):
            begin, end = blocking.get_block(block_id)
            inp, _ = port.utils.prediction._load_block(volume, begin, BLOCK_SHAPE, HALO)
            x = torch.from_numpy(port.standardize(inp)[None, None]).cuda()
            pred = model(x)[(0, slice(None)) + inner].half().float().cpu().numpy()
            actual = tuple(slice(0, e - b) for b, e in zip(begin, end))
            out[(slice(None),) + tuple(slice(b, e) for b, e in zip(begin, end))] = pred[(slice(None),) + actual]
    return out


def check_close(label, got, expected):
    diff = np.abs(got - expected)
    log(f"{label}: max abs diff {float(diff.max()):.3g}, mean {float(diff.mean()):.3g} "
        f"(limits {MODEL_BF16_MAX}, {MODEL_BF16_MEAN})")
    if float(diff.max()) > MODEL_BF16_MAX or float(diff.mean()) > MODEL_BF16_MEAN:
        raise AssertionError(f"{label} disagree")


def phase_main_path(port, inorm, unet_module):
    """Full-width tiled inference through both paths on both volumes; returns the norm
    kernel's launches summed over the timed calls, and their numbers."""
    model = port.AnisotropicUNet(**TRACKED, dtype=torch.bfloat16, device="cuda", seed=0)
    launches, results = 0, []
    for shape in SERVING_VOLUMES:
        volume = np.random.default_rng(0).random(shape, dtype=np.float32)
        host, host_stats = serve(port, inorm, model, volume, "host")
        device, device_stats = serve(port, inorm, model, volume, "device")
        check_close(f"{shape}: device-resident path vs host path", device, host)
        if shape == VOLUME_SHAPE:
            check_close(f"{shape}: host path vs a serial loop with host standardize", host,
                        serial_predict(port, model, volume))
        del host, device
        launches += host_stats["launches"] + device_stats["launches"]
        results += [host_stats, device_stats]
    log(f"serving: {json.dumps(results)}")
    volume = np.random.default_rng(0).random(VOLUME_SHAPE, dtype=np.float32)

    t = time.perf_counter()
    inp, _ = port.utils.prediction._load_block(volume, (0, 0, 0), BLOCK_SHAPE, HALO)
    inp = port.standardize(inp)
    host_ms = (time.perf_counter() - t) * 1e3
    x = torch.from_numpy(inp[None, None]).cuda()
    with torch.inference_mode():
        fwd_ms = time_ms(model, x, iters=3, repeats=1)
        torch.cuda.reset_peak_memory_stats()
        y_kernel = model(x)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with unittest.mock.patch.object(unet_module, "instance_norm", inorm.instance_norm_reference):
            y_plain = model(x)
    log(f"one halo block {tuple(x.shape)}: host load + standardize {host_ms:.1f} ms, "
        f"model forward {fwd_ms:.2f} ms on the device, peak memory {peak:.2f} GiB")
    with torch.inference_mode():
        device_breakdown("serving forward of one halo block (bf16)", lambda: model(x))
    diff = (y_kernel - y_plain).abs()
    log(f"bf16 block, kernel vs plain norm: max abs diff {float(diff.max()):.3g}, "
        f"mean {float(diff.mean()):.3g} (limits {MODEL_BF16_MAX}, {MODEL_BF16_MEAN})")
    if float(diff.max()) > MODEL_BF16_MAX or float(diff.mean()) > MODEL_BF16_MEAN:
        raise AssertionError("bf16 model with the kernel disagrees with the plain norm")

    model32 = port.AnisotropicUNet(**TRACKED, dtype=torch.float32, device="cuda", seed=0)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            y_kernel = model32(x)
            with unittest.mock.patch.object(unet_module, "instance_norm",
                                            inorm.instance_norm_reference):
                y_plain = model32(x)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    err = float((y_kernel - y_plain).abs().max())
    log(f"f32 block (TF32 off), kernel vs plain norm: max abs diff {err:.3g} "
        f"(limit {MODEL_F32_ATOL})")
    if err > MODEL_F32_ATOL:
        raise AssertionError("f32 model with the kernel disagrees with the plain norm")
    return launches


def check_backward(inorm, x, g):
    """Max abs error of the backward kernel against its plain version; raises past the tolerance."""
    _, mean, rstd = inorm.instance_norm_forward_reference(x)
    dx = inorm.instance_norm_backward(x, g, mean, rstd).float()
    ref = inorm.instance_norm_backward_reference(x, g, mean, rstd).float()
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    if x.dtype == torch.float32:
        tol = torch.full_like(ref, BWD_F32_RTOL_OF_MAX * scale)
    else:
        step = BWD_BF16_RTOL if x.dtype == torch.bfloat16 else BWD_F16_RTOL
        tol = step * ref.abs() + BWD_BF16_RTOL_OF_MAX * scale
    err = (dx - ref).abs()
    if not bool(torch.isfinite(dx).all()) or bool((err > tol).any()):
        raise AssertionError(f"backward kernel disagrees at {tuple(x.shape)} {x.dtype}: "
                             f"max abs err {float(err.max())} (max |dx| {scale})")
    return float(err.max())


def phase_backward_kernel(inorm, shapes, serving_shapes, dsb_shapes, spoco_shapes, vit_shapes, st_shapes,
                          spatial_shapes):
    """Check the backward kernel at every main-path shape (the DSB and SPOCO steps' at batch
    DSB_BATCH, the UNETR and ViM-UNet steps' and the encoder families' at their training batch,
    the self-training steps' and the MitoLab step's at their batch, the spatially sharded step's slab with its halo,
    ``spatial_shapes``) and time both kernels at the training paths' shapes and at that slab's level-0 rows.

    Returns the backward kernel's entry of the kernels line, with times summed
    over the norms whose backward one training step runs: all but the first,
    whose input is the raw patch, which needs no gradient; and the forward
    kernel's times per step of each training path."""
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rand(shape, dtype, offset=0):
        return card_rand(gen, shape, dtype, offset)

    max_err = 0.0
    for dtype in DTYPES:
        hit = set()
        for c, sp in sorted(set(shapes) | set(serving_shapes)):
            shape = (1, c) + sp
            err = check_backward(inorm, rand(shape, dtype), rand(shape, dtype))
            max_err = max(max_err, err)
            path = path_of(inorm, (c, sp), dtype, "backward")
            hit.add(path)
            log(f"  backward {dtype} C={c} {sp} path {path}: max abs err {err:.3g}")
        assert hit == {"A", "B", "C"}, hit
        for x in layout_cases(rand, dtype):
            max_err = max(max_err, check_backward(inorm, x, rand(x.shape, dtype)))
        # autograd may hand over a non-contiguous gradient; the wrapper copies it
        g = rand((1, 64, 8, 64, 64), dtype)[:, ::2]
        assert not g.is_contiguous()
        max_err = max(max_err, check_backward(inorm, rand(g.shape, dtype), g))
        log(f"  backward {dtype}: ragged, odd-length, misaligned, strided, channels-last and "
            f"non-contiguous-gradient cases agree")
        for recipe, batch, batch_shapes in (("DSB", DSB_BATCH, dsb_shapes), ("SPOCO", DSB_BATCH, spoco_shapes),
                                            *((name, b, s) for name, (b, s) in st_shapes.items())):
            for c, sp in sorted(set(batch_shapes)):
                shape = (batch, c) + sp
                err = check_backward(inorm, rand(shape, dtype), rand(shape, dtype))
                max_err = max(max_err, err)
                log(f"  backward {dtype} {recipe} {shape[:2]} {sp} path "
                    f"{path_of(inorm, (batch * c, sp), dtype, 'backward')}: max abs err {err:.3g}")
        seen = set()
        for recipe, (batch, recipe_shapes) in vit_shapes.items():
            for c, sp in sorted(set(recipe_shapes) - seen):
                shape = (batch, c) + sp
                err = check_backward(inorm, rand(shape, dtype), rand(shape, dtype))
                max_err = max(max_err, err)
                log(f"  backward {dtype} {recipe} {shape[:2]} {sp} path "
                    f"{path_of(inorm, (batch * c, sp), dtype, 'backward')}: max abs err {err:.3g}")
            seen.update(recipe_shapes)
        max_err = max(max_err, check_sharded_backward(inorm, rand, spatial_shapes, dtype))
    repeats = [((1, c) + sp, path) for path, (c, sp) in repeat_shapes(inorm, shapes, "backward").items()]
    repeats += [((DSB_BATCH, c) + sp, f"{path} (DSB)")
                for path, (c, sp) in dsb_paths(inorm, dsb_shapes, torch.bfloat16, "backward").items()]
    for shape, path in repeats:
        x, g = rand(shape, torch.bfloat16), rand(shape, torch.bfloat16)
        _, mean, rstd = inorm.instance_norm_forward_reference(x)
        if not torch.equal(inorm.instance_norm_backward(x, g, mean, rstd),
                           inorm.instance_norm_backward(x, g, mean, rstd)):
            raise AssertionError(f"backward kernel path {path} is not bitwise repeatable")
    log(f"backward kernel agrees with instance_norm_backward_reference: max abs err {max_err:.3g} "
        f"(f32 {BWD_F32_RTOL_OF_MAX}*max|dx|; bf16 {BWD_BF16_RTOL:.3g}*|ref| + "
        f"{BWD_BF16_RTOL_OF_MAX}*max|dx|; f16 {BWD_F16_RTOL:.3g}*|ref| + "
        f"{BWD_BF16_RTOL_OF_MAX}*max|dx|); two calls bitwise equal on paths {[p for _, p in repeats]}")

    fwd, bwd = time_step_norms(inorm, rand, shapes, 1, "tracked")
    dsb_fwd, dsb_bwd = time_step_norms(inorm, rand, dsb_shapes, DSB_BATCH, "DSB")
    spoco_fwd, spoco_bwd = time_step_norms(inorm, rand, spoco_shapes, DSB_BATCH, "SPOCO")
    # without skip connections (ViM-UNet, SAM2) the first norm reads the encoder's features, which need a gradient
    recipe_times = {name: time_step_norms(inorm, rand, s, b, name, first_has_grad=name in NO_SKIP)
                    for name, (b, s) in vit_shapes.items()}
    recipe_times.update({name: time_step_norms(inorm, rand, s, b, name) for name, (b, s) in st_shapes.items()})
    for c, sp in sorted(repeat_shapes(inorm, shapes, "backward").values()):
        time_step_norm(inorm, rand((1, c) + sp, torch.float16), rand((1, c) + sp, torch.float16),
                       f"C={c} {sp}")
    torch.cuda.empty_cache()
    level0 = {f"spatial_training C={c} {sp}": time_large_norm(inorm, rand((1, c) + sp, torch.bfloat16),
                                                               "spatial_training", backward=True)
              for c, sp in sorted(set(spatial_shapes)) if sp == spatial_shapes[0][1]}
    step_shapes = shapes[1:]
    return {
        "name": "instance_norm_backward",
        "route": "cuda",
        "source": "torch_em_tpu_torch/ops/csrc/instance_norm_bwd.cu",
        "replaces": "torch_em_tpu/ops/pallas/norm.py:94",
        "launches": None,
        "max_abs_err": max_err,
        "ms": bwd["ms"],
        "device_ms": bwd["device_ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"],
        "bound_by": "bytes",
        "library_ms": bwd["library_ms"],
        "paths": {**{f"{name}_training": path_counts(
                         inorm, [(b * c, sp) for c, sp in (s if name in NO_SKIP else s[1:])], torch.bfloat16, "backward")
                     for name, (b, s) in vit_shapes.items()},
                  "training": path_counts(inorm, step_shapes, torch.bfloat16, "backward"),
                  "dsb_training": path_counts(inorm, [(DSB_BATCH * c, sp) for c, sp in dsb_shapes[1:]],
                                              torch.bfloat16, "backward"),
                  "spoco_training": path_counts(inorm, [(DSB_BATCH * c, sp) for c, sp in spoco_shapes[1:]],
                                                torch.bfloat16, "backward"),
                  **{f"{name}_training": path_counts(inorm, [(b * c, sp) for c, sp in s[1:]], torch.bfloat16,
                                                     "backward") for name, (b, s) in st_shapes.items()},
                  "spatial_training": path_counts(inorm, spatial_shapes[1:], torch.bfloat16, "backward")},
        "sharded_level0": {k: v["backward"] for k, v in level0.items()},
        "dsb_training": dsb_bwd,
        "spoco_training": spoco_bwd,
        **{f"{name}_training": b for name, (f, b) in recipe_times.items()},
    }, fwd, dsb_fwd, spoco_fwd, {f"{name}_training": f for name, (f, b) in recipe_times.items()}, \
        {k: v["forward"] for k, v in level0.items()}


def time_step_norms(inorm, rand, shapes, batch, label, first_has_grad=False):
    """Both kernels' times per training step (bf16) summed over a step's norms: the forward
    at every norm, the backward at all but the first (whose input is the raw patch) unless
    ``first_has_grad``; returns (forward, backward)."""
    step_shapes = shapes if first_has_grad else shapes[1:]
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms")
    fwd, bwd = dict.fromkeys(keys, 0.0), dict.fromkeys(keys, 0.0)
    for c, sp in sorted(set(shapes)):
        f, b = time_step_norm(inorm, rand((batch, c) + sp, torch.bfloat16),
                              rand((batch, c) + sp, torch.bfloat16), f"{label} ({batch}, {c}) {sp}")
        n_fwd, n_bwd = shapes.count((c, sp)), step_shapes.count((c, sp))
        for key in keys:
            fwd[key] += n_fwd * f[key]
            bwd[key] += n_bwd * b[key]
    for name, t, n in (("forward", fwd, len(shapes)), ("backward", bwd, len(step_shapes))):
        log(f"per {label} training step, {name} ({n} norms, bf16): kernel {t['ms']:.3f} ms as called, "
            f"{t['device_ms']:.3f} ms device; plain {t['plain_ms']:.3f} ms, F.instance_norm "
            f"{t['library_ms']:.3f} ms; bound {t['bound_ms']:.3f} ms")
    return fwd, bwd


def time_step_norm(inorm, x, g, label):
    """Training-step times at one shape, forward (with its statistics) and backward:
    kernel as called and device-only, plain version, library call, byte bound."""
    F = torch.nn.functional
    size = x.numel() * x.element_size()
    _, mean, rstd = inorm.instance_norm_forward_reference(x)
    xr = x.detach().requires_grad_()
    yr = F.instance_norm(xr)
    f = {"ms": time_ms(inorm.instance_norm_forward, x),
         "device_ms": device_ms(inorm.instance_norm_forward, x),
         "plain_ms": time_ms(inorm.instance_norm_forward_reference, x),
         "library_ms": time_ms(F.instance_norm, x), "bound_ms": 2 * size / HBM_BYTES_PER_S * 1e3}
    b = {"ms": time_ms(inorm.instance_norm_backward, x, g, mean, rstd),
         "device_ms": device_ms(inorm.instance_norm_backward, x, g, mean, rstd),
         "plain_ms": time_ms(inorm.instance_norm_backward_reference, x, g, mean, rstd),
         "library_ms": time_ms(lambda: torch.autograd.grad(yr, xr, g, retain_graph=True)),
         "bound_ms": 3 * size / HBM_BYTES_PER_S * 1e3}
    paths = [path_of(inorm, (x.shape[1], tuple(x.shape[2:])), x.dtype, d) for d in ("forward", "backward")]
    log(f"  time {x.dtype} {label} fwd path {paths[0]}: kernel {f['ms']:.4f} ms as called, "
        f"{f['device_ms']:.4f} ms device; plain {f['plain_ms']:.4f} ms; F.instance_norm "
        f"{f['library_ms']:.4f} ms; bound {f['bound_ms']:.4f} ms | bwd path {paths[1]}: kernel "
        f"{b['ms']:.4f} ms as called, {b['device_ms']:.4f} ms device; plain {b['plain_ms']:.4f} "
        f"ms; F.instance_norm backward {b['library_ms']:.4f} ms; bound {b['bound_ms']:.4f} ms")
    return f, b


def training_volume(port, seed=0):
    """A seeded raw volume and instance labels derived from it: raw is smoothed noise,
    the labels the connected components of a threshold of raw smoothed once more."""
    from scipy import ndimage

    noise = np.random.default_rng(seed).normal(size=TRAIN_VOLUME).astype(np.float32)
    raw = ndimage.gaussian_filter(noise, 1.0)
    raw = (raw - raw.mean()) / raw.std()
    labels = port.transforms.connected_components(ndimage.gaussian_filter(raw, 2.0) > 0)
    return raw, labels


class LossLog:
    """Trainer logger that keeps the training losses and validation metrics."""

    def __init__(self, trainer, save_root, **kwargs):
        self.losses, self.metrics = [], []

    def log_train(self, step, loss, lr, x, y, prediction, log_gradients=False):
        self.losses.append(loss)

    def log_validation(self, step, metric, loss, x, y, prediction):
        self.metrics.append(metric)


def phase_training(port, inorm, device_ops):
    """The training path; returns the forward and backward kernel launches of its run."""
    raw, labels = training_volume(port)
    log(f"training volume {raw.shape}: {int(labels.max())} instances")
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "raw.npy"), raw)
        np.save(os.path.join(tmp, "labels.npy"), labels)
        del raw, labels

        def loader(n_samples, shuffle, label_transform=None):
            ds = port.SegmentationDataset(
                os.path.join(tmp, "raw.npy"), None, os.path.join(tmp, "labels.npy"), None,
                patch_shape=TRAIN_PATCH, n_samples=n_samples, raw_transform=port.standardize,
                label_transform=label_transform)
            return port.DataLoader(ds, batch_size=1, shuffle=shuffle, num_workers=LOADER_THREADS)

        np.random.seed(0)
        model = port.AnisotropicUNet(**TRACKED, device="cuda", seed=0)
        trainer = port.default_segmentation_trainer(
            "smoke", model, loader(TRAIN_SAMPLES, True), loader(VAL_SAMPLES, False),
            learning_rate=LEARNING_RATE, device="cuda", mixed_precision=True, logger=LossLog,
            save_root=tmp, device_label_transform=device_ops.DeviceAffinityTransform(offsets=OFFSETS))
        folder = trainer.checkpoint_folder

        inorm.instance_norm.launches = 0
        inorm.instance_norm_backward.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.fit(iterations=FIT_ITERATIONS)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
        resumed = port.DefaultTrainer.from_checkpoint(folder, "latest")
        if resumed.iteration != FIT_ITERATIONS:
            raise AssertionError(f"from_checkpoint restored iteration {resumed.iteration}")
        restored = resumed.device_label_transform
        if not (isinstance(restored, device_ops.DeviceAffinityTransform)
                and restored.init_kwargs == trainer.device_label_transform.init_kwargs):
            raise AssertionError(f"from_checkpoint restored the label transform {restored!r}")
        resumed.fit(iterations=RESUME_ITERATIONS)
        torch.cuda.synchronize()
        launches = (inorm.instance_norm.launches, inorm.instance_norm_backward.launches)

        steps = FIT_ITERATIONS + RESUME_ITERATIONS
        validations = len(trainer.logger.metrics) + len(resumed.logger.metrics)
        if trainer.iteration != FIT_ITERATIONS or trainer.epoch != 2 or resumed.iteration != steps:
            raise AssertionError(f"iterations {trainer.iteration}, epochs {trainer.epoch}, "
                                 f"resumed {resumed.iteration}")
        expected = (NORMS_PER_FORWARD * (steps + VAL_SAMPLES * validations),
                    (NORMS_PER_FORWARD - 1) * steps)
        log(f"training launches: forward {launches[0]}, backward {launches[1]} for {steps} steps "
            f"and {validations} validations of {VAL_SAMPLES} patches (expected {expected})")
        if launches != expected:
            raise AssertionError(f"kernel launches {launches}, expected {expected}")
        losses = trainer.logger.losses + resumed.logger.losses
        first, last = float(np.mean(losses[:4])), float(np.mean(losses[FIT_ITERATIONS - 4:FIT_ITERATIONS]))
        log(f"loss over {len(losses)} steps: first four {first:.4f}, last four of the first fit "
            f"{last:.4f}, last {losses[-1]:.4f}; validation metrics "
            f"{[round(m, 4) for m in trainer.logger.metrics + resumed.logger.metrics]}")
        if len(losses) != steps or not np.all(np.isfinite(losses)) or not last < first:
            raise AssertionError("the training loss is not finite or does not fall")
        saved = sorted(os.listdir(folder))
        if not {"best.ckpt", "latest.ckpt"} <= set(saved):
            raise AssertionError(f"checkpoints {saved}")
        log(f"fit {FIT_ITERATIONS} iterations in {fit_s:.2f} s wall ({fit_s / FIT_ITERATIONS * 1e3:.1f} "
            f"ms per iteration with data loading, 2 validations and checkpoints, "
            f"{FIT_ITERATIONS / fit_s:.2f} patches/s); checkpoints {saved}")

        check_label_transforms(resumed.train_loader.dataset, (
            (device_ops.DeviceAffinityTransform(offsets=OFFSETS), port.transforms.AffinityTransform(OFFSETS)),
            (device_ops.DeviceBoundaryTransform(), port.transforms.BoundaryTransform())))
        time_loaders(port, resumed, loader)

        # one training step on a device-resident batch
        x, y = (v.cuda() for v in next(iter(resumed.train_loader)))
        torch.cuda.reset_peak_memory_stats()
        step_ms = time_ms(resumed._train_step, x, y, iters=10, repeats=1)
        t = time.perf_counter()
        for _ in range(10):
            resumed._train_step(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) / 10 * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"training step {tuple(x.shape)} bf16: {step_ms:.2f} ms device (CUDA events), "
            f"{wall_ms:.2f} ms wall, {1e3 / wall_ms:.2f} patches/s, peak memory {peak:.2f} GiB; "
            f"{nvidia_smi()}")
        device_breakdown("training step (bf16 forward, backward, AdamW)",
                         lambda: resumed._train_step(x, y))
        del trainer, resumed, model
    torch.cuda.empty_cache()
    check_training_gradients(port, inorm, x, device_ops.DeviceAffinityTransform(offsets=OFFSETS)(y))
    return launches


def check_label_transforms(dataset, cases, n=4):
    """Each (on the card, on the host) pair of label transforms in ``cases`` on ``n`` label
    patches of ``dataset``: equal."""
    labels = torch.stack([torch.from_numpy(dataset[i][1]) for i in range(n)])  # (n, 1, *patch) float32
    for on_card, on_host in cases:
        got = on_card(labels.cuda()).cpu().numpy()
        expected = np.stack([on_host(sample[0]).astype(np.float32) for sample in labels.numpy()])
        if got.shape != expected.shape or not np.array_equal(got, expected):
            raise AssertionError(f"{type(on_card).__name__} on the card differs from "
                                 f"{type(on_host).__name__} on the host")
        log(f"{type(on_card).__name__} on the card equals {type(on_host).__name__} on the host on {n} "
            f"label patches {tuple(labels.shape[2:])} ({float(got.mean()):.4f} of the target set)")


def time_loaders(port, trainer, loader):
    """Patches/s of the loader (LOADER_THREADS threads) feeding training steps, as the
    tracked benchmark times it: the host ``AffinityTransform`` in the loader, then raw
    labels with ``DeviceAffinityTransform`` inside the step."""
    device_transform = trainer.device_label_transform
    for mode, label_transform, step_transform in (
            ("host AffinityTransform", port.transforms.AffinityTransform(OFFSETS), None),
            ("DeviceAffinityTransform in the step", None, device_transform)):
        trainer.device_label_transform = step_transform
        it = iter(loader(2 + LOADER_STEPS, True, label_transform))
        for k in range(2 + LOADER_STEPS):
            if k == 2:
                torch.cuda.synchronize()
                t = time.perf_counter()
            x, y = next(it)
            trainer._train_step(x.cuda(non_blocking=True), y.cuda(non_blocking=True))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        log(f"loader with {mode}, {LOADER_THREADS} threads, with the step: "
            f"{LOADER_STEPS / seconds:.2f} patches/s ({seconds / LOADER_STEPS * 1e3:.1f} ms per patch)")
    trainer.device_label_transform = device_transform


def check_training_gradients(port, inorm, x, y):
    """One float32 training step (TF32 off): the kernels against the plain versions,
    each against the same step in float64."""
    model = port.AnisotropicUNet(**TRACKED, dtype=torch.float32, device="cuda", seed=1)

    def grads(net, xb, yb):
        net.zero_grad(set_to_none=True)
        port.DiceLoss()(net(xb), yb).backward()
        return {n: p.grad.clone() for n, p in net.named_parameters()}

    def plain_forward(x, eps, stats=True):  # the entry of inputs that need no gradient
        return inorm.instance_norm_forward_reference(x, eps)

    plain_norm = [unittest.mock.patch.object(inorm, name, fn) for name, fn in (
        ("instance_norm_forward", inorm.instance_norm_forward_reference),
        ("instance_norm_backward", inorm.instance_norm_backward_reference),
        ("_instance_norm_cuda", plain_forward))]
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        kernel = grads(model, x, y)
        with plain_norm[0], plain_norm[1], plain_norm[2]:
            plain = grads(model, x, y)
            model.double()
            model.dtype = torch.float64
            exact = grads(model, x.double(), y.double())
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    largest = max(float(g.abs().max()) for g in exact.values())
    rows = []
    for name, ref in exact.items():
        dist_kernel = float((kernel[name].double() - ref).norm())
        dist_plain = float((plain[name].double() - ref).norm())
        tol = GRAD_L2_FACTOR * dist_plain + GRAD_ATOL_OF_MODEL * largest * ref.numel() ** 0.5
        size = max(float(ref.norm()), 1e-30)
        rows.append((dist_kernel / tol, name, dist_kernel / size, dist_plain / size,
                     float((kernel[name] - plain[name]).norm()) / size))
        if not bool(torch.isfinite(kernel[name]).all()) or dist_kernel > tol:
            raise AssertionError(f"gradient of {name} with the kernels is {dist_kernel:.3g} (L2) from "
                                 f"float64, the plain version's {dist_plain:.3g} (tolerance {tol:.3g})")
    for ratio, name, rel_kernel, rel_plain, rel_diff in sorted(rows, reverse=True)[:3]:
        log(f"  {name}: L2 distance from float64 {rel_kernel:.3g} (kernels), {rel_plain:.3g} (plain) "
            f"of its norm; kernels vs plain {rel_diff:.3g}; {ratio:.3g} of its tolerance")
    log(f"f32 training step (TF32 off): all {len(exact)} gradients with the kernels within "
        f"{GRAD_L2_FACTOR}x the plain version's L2 distance from float64 + "
        f"{GRAD_ATOL_OF_MODEL}*max|grad| per element (max|grad| {largest:.3g}); largest relative "
        f"distance from float64: kernels {max(r[2] for r in rows if r[3] < 1):.3g}, plain "
        f"{max(r[3] for r in rows if r[3] < 1):.3g}")


def fit_and_resume(port, inorm, trainer, fit_iterations, resume_iterations, val_patches, label, forwards=1,
                   check_resumed=None, norms=(NORMS_PER_FORWARD, NORMS_PER_FORWARD - 1), val_forwards=None,
                   backwards=1, falling=True, **fit_kwargs):
    """Fit (with ``fit_kwargs``), rebuild with ``from_checkpoint`` (then
    ``check_resumed(resumed)``), fit on; check iteration counts, a finite (and, with ``falling``,
    falling) loss, the checkpoints and both kernels' launches (counted from 0 here; ``forwards``
    model forwards per step, ``val_forwards`` per validation batch (``forwards`` when None),
    ``backwards`` backward passes per step, ``norms`` the forward norms of a forward and the
    backward ones of a pass). Returns the resumed trainer and the launches."""
    folder = trainer.checkpoint_folder
    torch.cuda.synchronize()
    inorm.instance_norm.launches = inorm.instance_norm_backward.launches = 0
    t = time.perf_counter()
    trainer.fit(iterations=fit_iterations, **fit_kwargs)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    resumed = port.DefaultTrainer.from_checkpoint(folder, "latest")
    if resumed.iteration != fit_iterations:
        raise AssertionError(f"{label}: from_checkpoint restored iteration {resumed.iteration}")
    if check_resumed is not None:
        check_resumed(resumed)
    resumed.fit(iterations=resume_iterations)
    torch.cuda.synchronize()
    launches = (inorm.instance_norm.launches, inorm.instance_norm_backward.launches)
    steps = fit_iterations + resume_iterations
    if trainer.iteration != fit_iterations or resumed.iteration != steps:
        raise AssertionError(f"{label}: iterations {trainer.iteration}, resumed {resumed.iteration}")
    validations = len(trainer.logger.metrics) + len(resumed.logger.metrics)
    val_forwards = forwards if val_forwards is None else val_forwards
    expected = (norms[0] * (forwards * steps + val_forwards * val_patches * validations), backwards * norms[1] * steps)
    log(f"{label}: launches forward {launches[0]}, backward {launches[1]} for {steps} steps and "
        f"{validations} validations of {val_patches} patch(es) (expected {expected})")
    if launches != expected:
        raise AssertionError(f"{label}: kernel launches {launches}, expected {expected}")
    losses = trainer.logger.losses + resumed.logger.losses
    first, last = float(np.mean(losses[:4])), float(np.mean(losses[fit_iterations - 4:fit_iterations]))
    log(f"{label}: loss over {len(losses)} steps: first four {first:.4f}, last four of the first fit "
        f"{last:.4f}, last {losses[-1]:.4f}; fit {fit_iterations} iterations in {fit_s:.2f} s wall")
    if len(losses) != steps or not np.all(np.isfinite(losses)) or (falling and not last < first):
        raise AssertionError(f"{label}: the training loss is not finite or does not fall")
    if not {"best.ckpt", "latest.ckpt"} <= set(os.listdir(folder)):
        raise AssertionError(f"{label}: checkpoints {os.listdir(folder)}")
    return resumed, launches


def loader_rate(trainer, loader, steps=LOADER_STEPS, warmup=2):
    """Patches/s of ``loader`` feeding the trainer's steps, after ``warmup`` steps."""
    it = iter(loader)
    for k in range(warmup + steps):
        if k == warmup:
            torch.cuda.synchronize()
            t = time.perf_counter()
        x, y = next(it)
        trainer._train_step(x.cuda(non_blocking=True), y.cuda(non_blocking=True))
    torch.cuda.synchronize()
    return steps * loader.batch_size / (time.perf_counter() - t)


def bare_step(trainer, loader, label):
    """Device ms (CUDA events) and wall ms of the trainer's step on a device-resident batch."""
    x, y = (v.cuda() for v in next(iter(loader)))
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(trainer._train_step, x, y, iters=10, repeats=1)
    t = time.perf_counter()
    for _ in range(10):
        trainer._train_step(x, y)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) / 10 * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{label} step {tuple(x.shape)} bf16: {step_ms:.2f} ms device (CUDA events), {wall_ms:.2f} ms wall, "
        f"{x.shape[0] * 1e3 / wall_ms:.2f} patches/s, peak memory {peak:.2f} GiB; {nvidia_smi()}")
    return x, y


def phase_factory_3d(port, inorm, device_ops):
    """The 3-D recipe through ``default_segmentation_loader``: a ConcatDataset over two
    ``.npy`` volumes with the default (anisotropic flip) augmentations and ``standardize``;
    returns the kernels' launches of its training run."""
    with tempfile.TemporaryDirectory() as tmp:
        raws, labels = [], []
        for seed in range(2):
            raw, lab = training_volume(port, seed)
            raws.append(os.path.join(tmp, f"raw{seed}.npy"))
            labels.append(os.path.join(tmp, f"labels{seed}.npy"))
            np.save(raws[-1], raw)
            np.save(labels[-1], lab)
        del raw, lab

        def loader(n_samples=None, shuffle=True, transform=None):
            return port.default_segmentation_loader(
                raws, None, labels, None, batch_size=1, patch_shape=TRAIN_PATCH, num_workers=LOADER_THREADS,
                shuffle=shuffle, n_samples=n_samples, transform=transform)

        train = loader()
        ds = train.dataset
        pipeline = ds.datasets[0].transform
        if not (isinstance(ds, port.data.ConcatDataset) and pipeline.init_kwargs == {
                "ndim": "anisotropic", "transforms": FLIPS_3D}):
            raise AssertionError(f"factory built {type(ds).__name__} with {pipeline.init_kwargs}")
        log(f"factory loader: {type(ds).__name__} of {len(ds.datasets)} volumes, {len(ds)} patches, "
            f"transform {pipeline.init_kwargs}, raw transform {type(ds.datasets[0].raw_transform).__name__}")
        np.random.seed(1)
        model = port.AnisotropicUNet(**TRACKED, device="cuda", seed=0)
        trainer = port.default_segmentation_trainer(
            "factory-3d", model, train, loader(n_samples=VAL_SAMPLES, shuffle=False),
            learning_rate=LEARNING_RATE, device="cuda", mixed_precision=True, logger=LossLog,
            save_root=tmp, device_label_transform=device_ops.DeviceAffinityTransform(offsets=OFFSETS))
        resumed, launches = fit_and_resume(port, inorm, trainer, RECIPE_FIT, RECIPE_RESUME, VAL_SAMPLES,
                                           "3-D recipe")
        restored = resumed.train_loader.dataset
        if not (isinstance(restored, port.data.ConcatDataset)
                and restored.datasets[0].transform.init_kwargs == pipeline.init_kwargs):
            raise AssertionError(f"from_checkpoint rebuilt {type(restored).__name__}")

        n = 2 + LOADER_STEPS  # patches per timed run, half from each volume
        no_transform = port.DataLoader(port.data.ConcatDataset(*[
            port.SegmentationDataset(r, None, lab, None, patch_shape=TRAIN_PATCH, n_samples=n // 2,
                                     raw_transform=port.standardize)
            for r, lab in zip(raws, labels)]), batch_size=1, shuffle=True, num_workers=LOADER_THREADS)
        elastic = port.transforms.get_augmentations(3, FLIPS_3D + ["RandomElasticDeformation3D"])
        for mode, modes_loader in (("no transform", no_transform), ("default flips", loader(n)),
                                   ("flips + RandomElasticDeformation3D", loader(n, transform=elastic))):
            rate = loader_rate(resumed, modes_loader)
            LOADER_RATES[f"7 {mode}"] = rate
            log(f"3-D loader, {mode}, {LOADER_THREADS} threads, DeviceAffinityTransform in the step: "
                f"{rate:.2f} patches/s ({1e3 / rate:.1f} ms per patch)")
        raw, lab = ds.datasets[0]._get_sample(0)
        elastic(raw, lab)
        t = time.perf_counter()
        for _ in range(3):
            out = elastic(raw, lab)
        log(f"host path of flips + RandomElasticDeformation3D on one {TRAIN_PATCH} raw and label patch, "
            f"alone: {(time.perf_counter() - t) / 3 * 1e3:.1f} ms per sample, {torch.get_num_threads()} "
            f"intra-op threads; outputs {[tuple(a.shape) for a in out]} {out[0].dtype}")
        del trainer, resumed, model
    torch.cuda.empty_cache()
    return launches


def tie_mask(aug, spatial, params):
    """Voxels (B, 1, *spatial) where a sampling coordinate of ``aug`` lies within AUG_TIE of a
    rounding tie of order 0 (None for the flips, which do not resample)."""
    if not aug.interpolating:
        return None
    coords = aug.coords(spatial, params)  # an elastic field covers the last two axes only
    near = torch.zeros_like(coords[0], dtype=torch.bool)
    for c in coords:
        near |= ((c - torch.floor(c)) - 0.5).abs() < AUG_TIE
    return near.reshape(near.shape[:1] + (1,) * (1 + len(spatial) - len(coords)) + near.shape[1:])


def phase_apply_batched(port):
    """Every registry entry through ``apply_batched``'s apply on the card and on the CPU with the
    same parameters; times each entry per batch on the card and per sample on the host."""
    from torch_em_tpu_torch.transforms import augmentation as A

    rows = []
    gen = torch.Generator().manual_seed(0)
    for name, kwargs in A.AUGMENTATIONS.items():
        aug = A.create_augmentation(name)
        planar = name in ("RandomRotation", "RandomAffine", "RandomElasticDeformation")
        for batch in AUG_BATCHES:
            # a 2-D entry cannot warp a 3-D patch (nor can the JAX package's): its 32 planes are channels
            shape = (batch,) + ((AUG_SHAPE[0],) + AUG_SHAPE[1:] if planar else (1,) + AUG_SHAPE)
            spatial = shape[2:]
            raw = torch.rand(shape, generator=gen)
            labels = torch.randint(0, 1000, shape, generator=gen)
            params = A._stack([aug.sample_params(gen, spatial) for _ in range(batch)])
            params["apply"] = torch.ones(batch, dtype=torch.bool)  # every element transformed
            on_card = {k: v.cuda() for k, v in params.items()}
            raw_cpu, lab_cpu = aug.apply_batch(raw, params, 1), aug.apply_batch(labels, params, 0)
            raw_card = aug.apply_batch(raw.cuda(), on_card, 1).cpu()
            lab_card = aug.apply_batch(labels.cuda(), on_card, 0).cpu()
            float_err = float((raw_card - raw_cpu).abs().max()) / float(raw.max() - raw.min())
            differ = lab_card != lab_cpu
            near = tie_mask(aug, spatial, params)
            unexplained = int((differ & ~near.expand_as(differ)).sum()) if near is not None else int(differ.sum())
            n_ties = int(near.expand_as(differ).sum()) if near is not None else 0
            if float_err > AUG_FLOAT_TOL or unexplained or int(differ.sum()) > AUG_TIE_SHARE * differ.numel():
                raise AssertionError(f"{name} {shape}: card vs CPU float err {float_err:.3g} of the range, "
                                     f"{int(differ.sum())} labels differ ({unexplained} away from a tie)")
            pipeline = A.AugmentationPipeline(aug)
            card_gen = card_generator(1)
            raw_c, lab_c = raw.cuda(), labels.cuda()
            card_ms = time_ms(lambda: pipeline.apply_batched(card_gen, raw_c, lab_c), iters=3, repeats=3)
            host_ms = None
            if batch == 1:
                raw_np, lab_np = raw[0].numpy(), labels[0].numpy().astype(np.uint32)
                pipeline(raw_np, lab_np)
                t = time.perf_counter()
                for _ in range(3):
                    pipeline(raw_np, lab_np)
                host_ms = (time.perf_counter() - t) / 3 * 1e3
            rows.append({"entry": name, "shape": list(shape), "float_err_of_range": float_err,
                         "labels_differ": int(differ.sum()), "near_ties": n_ties,
                         "card_ms_per_batch": card_ms, "host_ms_per_sample": host_ms})
            log(f"  {name} {shape}: card vs CPU float err {float_err:.3g} of the range, "
                f"{int(differ.sum())} labels differ ({n_ties} voxels near a tie); apply_batched "
                f"{card_ms:.3f} ms per batch on the card"
                + (f", host path {host_ms:.1f} ms per sample" if host_ms is not None else ""))
            del raw_c, lab_c
    log(f"apply_batched: {json.dumps(rows)}")
    torch.cuda.empty_cache()


def dsb_images(folder, seed=0):
    """DSB_IMAGES seeded 2-D images and instance labels as ``.npy`` under ``folder``/images and
    ``folder``/masks: raw is smoothed noise plus bright disks, the labels the disks."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    paths = {"images": [], "masks": []}
    for sub in paths:
        os.makedirs(os.path.join(folder, sub))
    for i in range(DSB_IMAGES):
        h, w = int(rng.integers(200, 361)), int(rng.integers(240, 361))
        labels = np.zeros((h, w), dtype=np.uint16)
        yy, xx = np.mgrid[:h, :w]
        for k in range(1, int(rng.integers(8, 20)) + 1):
            cy, cx, r = rng.integers(0, h), rng.integers(0, w), rng.integers(6, 20)
            labels[(yy - cy) ** 2 + (xx - cx) ** 2 <= r ** 2] = k
        raw = ndimage.gaussian_filter(rng.normal(size=(h, w)), 2.0) + 2.0 * (labels > 0)
        for sub, arr in (("images", raw.astype(np.float32)), ("masks", labels)):
            paths[sub].append(os.path.join(folder, sub, f"{i:02d}.npy"))
            np.save(paths[sub][-1], arr)
    return paths["images"], paths["masks"]


def phase_dsb(port, inorm):
    """The DSB recipe: UNet2d at DSB width through ``default_segmentation_loader`` over image
    files, bf16, then the training and tiled-prediction CLI in subprocesses; returns the
    kernels' launches of its training run."""
    from torch_em_tpu_torch.transforms import AugmentationPipeline, BoundaryTransform

    with tempfile.TemporaryDirectory() as tmp:
        raw_files, label_files = dsb_images(tmp)
        shapes = sorted({np.load(f, mmap_mode="r").shape for f in raw_files})
        log(f"DSB data: {len(raw_files)} images from {shapes[0]} to {shapes[-1]}")

        def loader(n_samples, shuffle, workers=LOADER_THREADS):
            return port.default_segmentation_loader(
                raw_files, None, label_files, None, batch_size=DSB_BATCH, patch_shape=DSB_PATCH, ndim=2,
                is_seg_dataset=False, label_transform=BoundaryTransform(add_binary_target=True),
                num_workers=workers, shuffle=shuffle, n_samples=n_samples)

        by_list = loader(DSB_BATCH * DSB_FIT, True).dataset
        by_glob = port.default_segmentation_dataset(
            os.path.join(tmp, "images"), "*.npy", os.path.join(tmp, "masks"), "*.npy", patch_shape=DSB_PATCH,
            ndim=2, label_transform=BoundaryTransform(add_binary_target=True), n_samples=DSB_BATCH * DSB_FIT)
        for ds in (by_list, by_glob):
            if not (type(ds).__name__ == "ImageCollectionDataset"
                    and ds.transform.init_kwargs == {"ndim": 2, "transforms": ["RandomHorizontalFlip",
                                                                              "RandomVerticalFlip"]}):
                raise AssertionError(f"DSB factory built {type(ds).__name__}")
            ds.transform = AugmentationPipeline(*ds.transform.augmentations, seed=0)
        for i in range(4):
            np.random.seed(i)
            a = by_list[i]
            np.random.seed(i)
            b = by_glob[i]
            if not all(np.array_equal(u, v) for u, v in zip(a, b)) or a[0].shape != DSB_PATCH:
                raise AssertionError("the file-list and folder-glob DSB datasets differ")
        log(f"DSB: file-list and folder-glob datasets give equal samples {a[0].shape}, {a[1].shape}")

        np.random.seed(2)
        model = port.UNet2d(**DSB_MODEL, depth=DSB_DEPTH, device="cuda", seed=0)
        trainer = port.default_segmentation_trainer(
            "dsb", model, loader(DSB_BATCH * DSB_FIT, True), loader(DSB_BATCH, False),
            learning_rate=LEARNING_RATE, device="cuda", mixed_precision=True, logger=LossLog, save_root=tmp)
        resumed, launches = fit_and_resume(port, inorm, trainer, DSB_FIT, DSB_RESUME, 1, "DSB recipe")
        if type(resumed.train_loader.dataset).__name__ != "ImageCollectionDataset":
            raise AssertionError("from_checkpoint did not rebuild the DSB loader")
        rate = loader_rate(resumed, loader(DSB_BATCH * (LOADER_STEPS + 2), True), steps=LOADER_STEPS)
        log(f"DSB loader, {LOADER_THREADS} threads, feeding steps: {rate:.2f} patches/s "
            f"({rate / DSB_BATCH:.2f} batches/s)")
        x, y = bare_step(resumed, loader(DSB_BATCH, False), "DSB")
        device_breakdown("DSB training step (bf16 forward, backward, AdamW)", lambda: resumed._train_step(x, y))
        del trainer, resumed, model, x, y
        torch.cuda.empty_cache()
        run_cli(tmp)
    return launches


def run_cli(tmp):
    """``train_2d_unet`` for DSB_CLI_ITERATIONS iterations on the DSB folders, then
    ``predict_with_tiling`` on its checkpoint into a ``.npy`` file, each in a subprocess."""
    def cli(entry, args):
        code = (f"import sys; sys.argv = ['{entry}'] + {args!r}\n"
                f"from torch_em_tpu_torch.cli import {entry}\n{entry}()\n")
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], cwd=tmp, env=env, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"{entry} failed: {proc.stderr[-3000:]}")
        last = (proc.stdout.strip().splitlines() or ["(no output)"])[-1]
        log(f"{entry} ran in {time.perf_counter() - t:.1f} s: {last}")

    cli("train_2d_unet", ["-i", os.path.join(tmp, "images"), "-l", os.path.join(tmp, "masks"),
                          "-k", "*.npy", "--training_label_key", "*.npy", "-b", str(DSB_BATCH),
                          "-p", *map(str, DSB_PATCH), "-n", str(DSB_CLI_ITERATIONS),
                          "-m", "boundaries_and_foreground", "--name", "dsb-cli"])
    volume = np.stack([np.load(os.path.join(tmp, "images", f"{i:02d}.npy"))[:200, :240] for i in range(2)])
    np.save(os.path.join(tmp, "volume.npy"), volume)
    cli("predict_with_tiling", ["-c", os.path.join(tmp, "checkpoints", "dsb-cli"), "-i",
                                os.path.join(tmp, "volume.npy"), "-o", os.path.join(tmp, "out.npy"),
                                "--output_key", "pred", "-b", "1", "128", "128", "--halo", "0", "16", "16"])
    out = np.load(os.path.join(tmp, "out.npy"))
    if out.shape != (2,) + volume.shape or not np.isfinite(out).all():  # the CLI's model has no activation
        raise AssertionError(f"predict_with_tiling wrote {out.shape}, finite: {np.isfinite(out).all()}")
    log(f"predict_with_tiling wrote {out.shape} {out.dtype}, finite, in [{out.min():.3f}, {out.max():.3f}]")


def snemi_volume(seed):
    """A seeded EM-like volume of SNEMI_VOLUME and its space-filling instance labels: the
    nearest of seeds on a jittered grid of SNEMI_CELL (z measured 3x coarser), found at half
    resolution and repeated 2x per axis; raw shows dark membranes at the cells' boundaries,
    blurred, with noise."""
    from scipy import ndimage

    from torch_em_tpu_torch.ops.host import find_boundaries

    rng = np.random.default_rng(seed)
    coarse = tuple(s // 2 for s in SNEMI_VOLUME)
    grid = np.stack(np.meshgrid(*[np.arange(c // 4, s, c // 2) for s, c in zip(coarse, SNEMI_CELL)],
                                indexing="ij"), -1).reshape(-1, len(coarse))
    jitter = np.stack([rng.integers(-(c // 6), c // 6 + 1, len(grid)) for c in SNEMI_CELL], 1)
    centers = np.clip(grid + jitter, 0, np.array(coarse) - 1)
    seeds = np.zeros(coarse, dtype=np.uint32)
    seeds[tuple(centers.T)] = np.arange(1, len(centers) + 1)
    nearest = ndimage.distance_transform_edt(seeds == 0, sampling=(3.0, 1.0, 1.0), return_distances=False,
                                             return_indices=True)
    labels = seeds[tuple(nearest)]
    for axis in range(labels.ndim):
        labels = np.repeat(labels, 2, axis=axis)
    raw = 0.75 - 0.55 * ndimage.gaussian_filter(find_boundaries(labels).astype(np.float32), (0.5, 1.0, 1.0))
    raw += 0.03 * rng.standard_normal(SNEMI_VOLUME, dtype=np.float32)
    return np.clip(raw, 0, 1), labels


def decode(affinities):
    """``mutex_watershed_segmentation`` of (disaffinity) ``affinities`` with all voxels foreground;
    returns the segmentation and the seconds it took."""
    from torch_em_tpu_torch.utils.segmentation import mutex_watershed_segmentation

    t = time.perf_counter()
    seg = mutex_watershed_segmentation(np.ones(affinities.shape[1:], dtype=np.float32), affinities, SNEMI_OFFSETS)
    return seg, time.perf_counter() - t


def phase_snemi(port, inorm, device_ops):
    """The SNEMI recipe at full width: the tracked model with a 12-channel affinity head trained
    through ``default_segmentation_loader`` with the host ``AffinityTransform(add_mask=True)``
    and masked Dice, resumed from its checkpoint, served through both paths, decoded with the
    mutex watershed, checked against an oracle decode of exact targets, and validated with
    ``validate_checkpoint``. Returns the kernels' launches of its training, serving and
    validation runs and its numbers."""
    from torch_em_tpu_torch.loss import ApplyAndRemoveMask, LossWrapper
    from torch_em_tpu_torch.metric import rand_index, variation_of_information
    from torch_em_tpu_torch.utils.validation import validate_checkpoint

    stats = {}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        raws, labels = [], []
        for seed in range(2):
            raw, lab = snemi_volume(seed)
            raws.append(os.path.join(tmp, f"raw{seed}.npy"))
            labels.append(os.path.join(tmp, f"labels{seed}.npy"))
            np.save(raws[-1], raw)
            np.save(labels[-1], lab)
        volume, gt = raw, lab  # the second volume is served and decoded
        log(f"SNEMI data: 2 volumes {SNEMI_VOLUME}, {int(gt.max())} instances in the second, made in "
            f"{time.perf_counter() - t:.1f} s")
        host_transform = port.transforms.AffinityTransform(SNEMI_OFFSETS, add_mask=True)
        card_transform = device_ops.DeviceAffinityTransform(SNEMI_OFFSETS, add_mask=True)

        def loader(n_samples=None, shuffle=True, label_transform2=host_transform):
            return port.default_segmentation_loader(
                raws, None, labels, None, batch_size=1, patch_shape=TRAIN_PATCH, num_workers=LOADER_THREADS,
                shuffle=shuffle, n_samples=n_samples, label_transform2=label_transform2)

        masked_dice = LossWrapper(port.DiceLoss(), ApplyAndRemoveMask(masking_method="multiply"))
        np.random.seed(3)
        model = port.AnisotropicUNet(**dict(TRACKED, out_channels=len(SNEMI_OFFSETS)), device="cuda", seed=0)
        trainer = port.default_segmentation_trainer(
            "snemi", model, loader(SNEMI_FIT), loader(VAL_SAMPLES, shuffle=False), loss=masked_dice,
            metric=masked_dice, learning_rate=LEARNING_RATE, device="cuda", mixed_precision=True, logger=LossLog,
            save_root=tmp)
        resumed, training = fit_and_resume(port, inorm, trainer, SNEMI_FIT, SNEMI_RESUME, VAL_SAMPLES,
                                           "SNEMI recipe")
        folder = trainer.checkpoint_folder

        check_label_transforms(loader(4, label_transform2=None).dataset, ((card_transform, host_transform),))
        for mode, label_transform2, step_transform in (("host AffinityTransform", host_transform, None),
                                                       ("DeviceAffinityTransform in the step", None, card_transform)):
            resumed.device_label_transform = step_transform
            rate = loader_rate(resumed, loader(2 + LOADER_STEPS, label_transform2=label_transform2))
            stats[f"loader {mode}"] = rate
            log(f"SNEMI loader, {mode} (12 offsets and masks), {LOADER_THREADS} threads, with the step: "
                f"{rate:.2f} patches/s ({1e3 / rate:.1f} ms per patch)")
        resumed.device_label_transform = None
        bare_step(resumed, loader(1, shuffle=False), "SNEMI")

        served = resumed.model.eval()
        served.dtype = torch.bfloat16
        outputs, serving = {}, 0
        for path in ("host", "device"):
            outputs[path], stats[f"serving {path}"] = serve(port, inorm, served, volume, path, block_shape=SNEMI_BLOCK)
            serving += stats[f"serving {path}"]["launches"]
        check_close(f"SNEMI {volume.shape}: device-resident path vs host path", outputs["device"], outputs["host"])
        crop = (slice(None),) + tuple(slice(0, c) for c in SNEMI_DECODE)
        seg, seconds = decode(outputs["host"][crop].astype(np.float32))
        del outputs
        stats["decode_mvox_per_s"] = int(np.prod(SNEMI_DECODE)) / seconds / 1e6
        log(f"mutex watershed of the served prediction's {SNEMI_DECODE} crop: {int(seg.max())} segments in "
            f"{seconds:.2f} s on the host ({stats['decode_mvox_per_s']:.3f} Mvox/s)")
        if seg.max() == 0:
            raise AssertionError("the mutex watershed of the served prediction is empty")

        gt_crop = gt[crop[1:]]
        seg, seconds = decode(port.transforms.AffinityTransform(SNEMI_OFFSETS)(gt_crop).astype(np.float32))
        split, merge = variation_of_information(seg, gt_crop)
        are, _ = rand_index(seg, gt_crop)
        stats["oracle"] = {"voi": split + merge, "adapted_rand_error": are, "seconds": seconds}
        log(f"oracle: the exact targets of a {SNEMI_DECODE} ground-truth crop ({len(np.unique(gt_crop))} "
            f"instances) decode to {int(seg.max())} segments in {seconds:.2f} s: VOI {split + merge:.4g} (limit "
            f"{ORACLE_VOI}), adapted Rand error {are:.4g} (limit {ORACLE_ARE})")
        if not (split + merge < ORACLE_VOI and are < ORACLE_ARE):
            raise AssertionError("the mutex watershed of exact affinities does not recover the ground truth")

        def mws_voi(target, prediction):
            seg, _ = decode(prediction)
            return sum(variation_of_information(seg, target))

        sample = tuple(slice(0, c) for c in SNEMI_VALIDATE)
        torch.cuda.synchronize()
        inorm.instance_norm.launches = 0
        scores = validate_checkpoint(folder, samples=[(volume[sample], gt[sample])], metrics=mws_voi, visualize=False,
                                     block_shape=SNEMI_VALIDATE_BLOCK, halo=HALO)
        torch.cuda.synchronize()
        validation = inorm.instance_norm.launches
        log(f"validate_checkpoint on the card: VOI {scores} of the MWS decode of one {SNEMI_VALIDATE} sample; "
            f"{validation} norm launches")
        if len(scores) != 1 or not np.isfinite(scores[0]) or validation != NORMS_PER_FORWARD:
            raise AssertionError(f"validate_checkpoint gave {scores} with {validation} norm launches")
        log(f"SNEMI: {json.dumps(stats)}")
        del trainer, resumed, model, served
    torch.cuda.empty_cache()
    return training[0] + serving + validation, training[1]


def phase_spoco(port, inorm):
    """The SPOCO recipe at full width: ``SPOCOTrainer`` with its EMA network trains UNet2d
    embeddings with ``SPOCOLoss`` on the DSB images, resumes from its checkpoint (model2
    restored bitwise), holds one EMA update against the CPU, times the step, the loader and
    the loss, then predicts the embeddings of images on the card and grid-searches their
    embedding mutex watershed on the host. Returns the kernels' launches of its training and
    prediction."""
    from torch_em_tpu_torch.loss import ContrastiveLoss, SPOCOLoss
    from torch_em_tpu_torch.metric.instance_segmentation_metric import EmbeddingMWS
    from torch_em_tpu_torch.trainer import SPOCOTrainer
    from torch_em_tpu_torch.transforms import connected_components
    from torch_em_tpu_torch.utils.grid_search import instance_segmentation_grid_search

    stats = {}
    with tempfile.TemporaryDirectory() as tmp:
        raw_files, label_files = dsb_images(tmp)

        def loader(n_samples, shuffle=True):
            return port.default_segmentation_loader(
                raw_files, None, label_files, None, batch_size=DSB_BATCH, patch_shape=DSB_PATCH, ndim=2,
                is_seg_dataset=False, label_transform=connected_components, label_dtype="int32",
                num_workers=LOADER_THREADS, shuffle=shuffle, n_samples=n_samples)

        np.random.seed(4)
        model = port.UNet2d(**SPOCO_MODEL, depth=SPOCO_DEPTH, device="cuda", seed=0)
        trainer = SPOCOTrainer(
            name="spoco", model=model, train_loader=loader(DSB_BATCH * SPOCO_FIT),
            val_loader=loader(DSB_BATCH, False), loss=SPOCOLoss(**SPOCO_LOSS), metric=ContrastiveLoss(**SPOCO_LOSS),
            optimizer=port.OptimizerSpec("adamw", lr=LEARNING_RATE), momentum=SPOCO_MOMENTUM, mixed_precision=True,
            device="cuda", logger=LossLog, save_root=tmp)

        def model2_restored(resumed):
            saved = trainer.model2.state_dict()
            restored = resumed.model2.state_dict()
            if not (type(resumed) is SPOCOTrainer and resumed.momentum == SPOCO_MOMENTUM
                    and restored.keys() == saved.keys() and all(torch.equal(restored[k], saved[k]) for k in saved)):
                raise AssertionError("from_checkpoint did not restore model2 bitwise")
            if all(torch.equal(restored[k], resumed.model.state_dict()[k]) for k in saved):
                raise AssertionError("model2 equals the model: the moving average did not trail it")
            log(f"SPOCO: from_checkpoint restored model2 bitwise ({len(saved)} tensors), a moving average "
                f"that trails the model")

        resumed, launches = fit_and_resume(port, inorm, trainer, SPOCO_FIT, SPOCO_RESUME, 1, "SPOCO recipe",
                                           forwards=2, check_resumed=model2_restored)
        check_ema(resumed.model2, resumed.model, resumed.ema_update, resumed.momentum, stats)

        rate = loader_rate(resumed, loader(DSB_BATCH * (LOADER_STEPS + 2)), steps=LOADER_STEPS)
        stats["loader_patches_per_s"] = rate
        log(f"SPOCO loader, {LOADER_THREADS} threads, connected_components, feeding steps: {rate:.2f} patches/s "
            f"({rate / DSB_BATCH:.2f} batches/s)")
        x, y = bare_step(resumed, loader(DSB_BATCH, False), "SPOCO")
        stats["step_ms"] = time_ms(resumed._train_step, x, y, iters=10, repeats=3)
        stats["step"] = device_breakdown("SPOCO training step (bf16 forwards of both networks, backward, AdamW, EMA)",
                                         lambda: resumed._train_step(x, y))
        with resumed._compute_precision():
            with torch.no_grad():
                pred2 = resumed.model2(x)
            pred = resumed.model(x).detach().requires_grad_()
        if not (pred.dtype == pred2.dtype == torch.float32 and tuple(pred.shape) == (DSB_BATCH, 8) + DSB_PATCH[1:]):
            raise AssertionError(f"SPOCO predictions {pred.dtype} {tuple(pred.shape)}")

        def loss_step():
            resumed.loss((pred, pred2), y, generator=resumed.generator).backward()

        stats["loss_ms"] = time_ms(loss_step, iters=10, repeats=3)
        stats["loss"] = device_breakdown("SPOCO loss forward and backward (float32, batch 8)", loss_step)
        log(f"SPOCO step {stats['step_ms']:.2f} ms as called: the loss's forward and backward {stats['loss_ms']:.2f} "
            f"ms ({stats['loss_ms'] / stats['step_ms']:.1%}), its device kernels {stats['loss']['device_ms']:.2f} ms "
            f"({stats['loss']['device_ms'] / stats['step']['device_ms']:.1%} of the step's); the norms "
            f"{stats['step']['norm_ms']:.2f} ms ({stats['step']['norm_ms'] / stats['step']['device_ms']:.1%})")
        del x, y, pred, pred2

        network = resumed.model.eval()

        class Segmenter:
            """Embeddings predicted on the card; the embedding mutex watershed on the host."""

            def initialize(self, image):
                self.emb = port.predict_with_padding(network, image, min_divisible=(16, 16))[0]
                if not (self.emb.shape == (8,) + image.shape and np.isfinite(self.emb).all()):
                    raise AssertionError(f"SPOCO embeddings {self.emb.shape}, finite {np.isfinite(self.emb).all()}")

            def generate(self, delta, min_seg_size):
                return EmbeddingMWS(delta, SPOCO_OFFSETS, with_background=True, min_seg_size=min_seg_size)(self.emb)

        images, gts = raw_files[:SPOCO_DECODE_IMAGES], label_files[:SPOCO_DECODE_IMAGES]
        torch.cuda.synchronize()
        inorm.instance_norm.launches = 0
        t = time.perf_counter()
        best, score = instance_segmentation_grid_search(Segmenter(), images, gts, os.path.join(tmp, "grid"),
                                                        SPOCO_GRID)
        seconds = time.perf_counter() - t
        torch.cuda.synchronize()
        predicted = inorm.instance_norm.launches
        segmenter = Segmenter()
        segmenter.initialize(np.load(images[0]))
        t = time.perf_counter()
        seg = segmenter.generate(**best)
        decode_s = time.perf_counter() - t
        n_settings = int(np.prod([len(v) for v in SPOCO_GRID.values()]))
        stats["grid_search"] = {"best": best, "score": score, "s_per_image": seconds / len(images),
                                "decode_s": decode_s, "pixels": int(seg.size)}
        log(f"SPOCO grid search over {SPOCO_GRID} on {len(images)} images (embeddings predicted on the card, "
            f"{predicted} norm launches): best {best}, accuracy {score:.4f}; {seconds / len(images):.2f} s per "
            f"image for {n_settings} decodes, one decode of {seg.shape} {decode_s:.3f} s on the host "
            f"({seg.size / decode_s / 1e6:.3f} Mpix/s), {len(np.unique(seg)) - 1} segments")
        tables = sorted(os.listdir(os.path.join(tmp, "grid")))
        if not (0 <= score <= 1 and predicted == NORMS_PER_FORWARD * len(images) and len(tables) == len(images) + 1):
            raise AssertionError(f"grid search: score {score}, {predicted} norm launches, tables {tables}")
        log(f"SPOCO: {json.dumps(stats)}")
        del trainer, resumed, model, network
    torch.cuda.empty_cache()
    return launches[0] + predicted, launches[1]


def check_ema(target, source_model, update, m, stats):
    """One moving-average update (``update()``) of ``target`` on the card against t * m + s * (1 - m)
    on the CPU from the same tensors, s those of ``source_model``."""
    before = {k: v.detach().cpu().clone() for k, v in target.state_dict().items()}
    source = {k: v.detach().cpu() for k, v in source_model.state_dict().items()}
    update()
    torch.cuda.synchronize()
    err = 0.0
    for name, value in target.state_dict().items():
        expected = before[name] * m + source[name] * (1.0 - m)
        got = value.cpu()
        if not torch.allclose(got, expected, rtol=EMA_RTOL, atol=EMA_ATOL):
            raise AssertionError(f"EMA update of {name} on the card differs from the CPU's")
        err = max(err, float((got - expected).abs().max()))
    stats["ema_ms"] = time_ms(update, iters=10, repeats=3)
    log(f"EMA update on the card of {len(before)} tensors: max abs err {err:.3g} against the CPU (rtol "
        f"{EMA_RTOL}, atol {EMA_ATOL}); {stats['ema_ms']:.3f} ms as called")


def _relative_l2(got, expected, names):
    """L2 distance of the tensors ``names`` of ``got`` from ``expected``, over their L2 norm, all together."""
    dist = sum(float((got[n] - expected[n]).double().norm()) ** 2 for n in names)
    return (dist / sum(float(expected[n].double().norm()) ** 2 for n in names)) ** 0.5


def phase_norm_variants(port, card="cuda"):
    """UNet2d and UNet3d with each of the other norms: forward and backward on the card in bfloat16
    and float32 against the same model on the CPU, each held to float64 on the CPU, in training
    mode, from the same weights and input."""
    rows = []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for factory, shape in ((port.UNet2d, (2, 1, 64, 64)), (port.UNet3d, (2, 1, 16, 32, 32))):
            x = torch.from_numpy(np.random.default_rng(5).normal(0.5, 1.0, size=shape).astype(np.float32))
            for norm in NORM_VARIANTS:
                runs = {}
                for where, device, dtype in (("card", card, torch.bfloat16), ("card", card, torch.float32),
                                             ("cpu", "cpu", torch.bfloat16), ("cpu", "cpu", torch.float32),
                                             ("cpu", "cpu", torch.float64)):
                    model = factory(1, 2, depth=2, initial_features=16, norm=norm, dtype=dtype, device=device, seed=1)
                    if dtype == torch.float64:
                        model.double()
                    model.train()
                    out = model(x.to(device, torch.float64 if dtype == torch.float64 else torch.float32))
                    ((out - 1.0) ** 2).mean().backward()
                    run = {"output": out.detach().double().cpu(),
                           **{n: p.grad.double().cpu() for n, p in model.named_parameters()}}
                    if not all(bool(torch.isfinite(v).all()) for v in run.values()):
                        raise AssertionError(f"{factory.__name__} norm={norm} on the {where} in {dtype}: not finite")
                    runs[(where, dtype)] = run
                ref = runs[("cpu", torch.float64)]
                parts = {"output": ["output"], "gradients": [n for n in ref if n != "output"]}
                row = {}
                for dtype in (torch.float32, torch.bfloat16):
                    for what, names in parts.items():
                        on_card, on_cpu = (_relative_l2(runs[(where, dtype)], ref, names) for where in ("card", "cpu"))
                        limit = VARIANT_FACTOR * on_cpu + VARIANT_SLACK[dtype]
                        row[f"{str(dtype)[6:]} {what}"] = (float(f"{on_card:.3g}"), float(f"{on_cpu:.3g}"))
                        if not on_card <= limit:
                            raise AssertionError(f"{factory.__name__} norm={norm}: {what} in {dtype} on the card "
                                                 f"{on_card:.3g} (L2) from float64, on the CPU {on_cpu:.3g}, "
                                                 f"limit {limit:.3g}")
                rows.append((factory.__name__, norm, row))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    log(f"other norms, relative L2 from float64 on the CPU (card, CPU): {rows} (limits: {VARIANT_FACTOR}x the "
        f"CPU's + {VARIANT_SLACK[torch.float32]} in float32, + {VARIANT_SLACK[torch.bfloat16]} in bfloat16)")


def livecell_images(folder, seed=0):
    """VIT_IMAGES seeded grayscale images of LIVECell's size and their instance labels as
    ``.npy`` under ``folder``: the port's synthetic nucleus images (``utils/test.py:make_image``)
    at 704x704, cropped to 520x704."""
    from torch_em_tpu_torch.utils.test import make_image

    rng = np.random.default_rng(seed)
    paths = {"images": [], "masks": []}
    for sub in paths:
        os.makedirs(os.path.join(folder, sub))
    for i in range(VIT_IMAGES):
        raw, labels = make_image(rng, max(LIVECELL_SHAPE))
        crop = tuple(slice(0, s) for s in LIVECELL_SHAPE)
        for sub, arr in (("images", raw[crop]), ("masks", labels[crop])):
            paths[sub].append(os.path.join(folder, sub, f"{i:02d}.npy"))
            np.save(paths[sub][-1], arr)
    return paths["images"], paths["masks"]


def check_cpu_against_card(label, factory, kwargs, inputs, atol=VIT_CPU_ATOL):
    """The model built from one seed on the CPU and on the card: the same weights, and float32
    outputs (TF32 off) within ``atol`` on each input; for UNETR also the encoder's features
    at the smaller input, where its position embedding and relative-position tables shrink."""
    cpu_model = factory(**kwargs, device="cpu", seed=0)
    card_model = factory(**kwargs, device="cuda", seed=0)
    card_state = card_model.state_dict()
    if not all(torch.equal(v, card_state[k].cpu()) for k, v in cpu_model.state_dict().items()):
        raise AssertionError(f"{label}: the same seed gave other weights on the card")
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    errors = {}
    try:
        with torch.inference_mode():
            for x in inputs:
                expected, got = cpu_model(x), card_model(x.cuda()).cpu()
                err = float((got - expected).abs().max())
                errors[f"output {tuple(x.shape[2:])}"] = err
                if not (got.shape == expected.shape and bool(torch.isfinite(got).all()) and err <= atol):
                    raise AssertionError(f"{label} {tuple(x.shape)}: card against CPU max abs err {err}")
                if label == "UNETR":
                    x3 = x.repeat(1, 3, 1, 1)
                    feat_cpu, feat_card = cpu_model.encoder(x3)[0], card_model.encoder(x3.cuda())[0].cpu()
                    rel = float((feat_card - feat_cpu).abs().max() / feat_cpu.abs().max())
                    errors[f"encoder features {tuple(x.shape[2:])}"] = rel
                    if rel > VIT_FEATURE_RTOL:
                        raise AssertionError(f"{label} encoder at {tuple(x.shape)}: relative err {rel}")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    log(f"{label}: the seeded weights equal on the CPU and the card; float32 (TF32 off) card against CPU "
        f"{json.dumps(errors)} (limits {atol} abs on outputs, {VIT_FEATURE_RTOL} of the largest on "
        f"encoder features)")
    del cpu_model, card_model
    torch.cuda.empty_cache()
    return errors


def sdpa_report(vit_module, batch):
    """Which scaled_dot_product_attention backends take a global block's bf16 attention with its
    float bias (the step's shape; the step's profile shows which one runs), and what the bf16 bias
    costs against the JAX package's float32 logits, bias and softmax (the port's plain version),
    each against float64, in error and in time."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    gen = card_generator(12)
    heads, tokens, dim = 12, 1024, 64
    q, k, v = (torch.randn(batch, heads, tokens, dim, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    bias = torch.randn(batch, heads, tokens, tokens, generator=gen, device="cuda") * 2
    accepted = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.MATH):
        try:
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore")  # each refusing backend warns why
                torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=bias.to(q.dtype))
            torch.cuda.synchronize()
            accepted[backend.name] = True
        except RuntimeError:
            accepted[backend.name] = False
    exact = vit_module._attention_plain(q.double(), k.double(), v.double(), bias.double())
    plain = vit_module._attention_plain(q, k, v, bias)
    fused = vit_module._attention(q, k, v, bias)
    scale = float(exact.abs().max())
    report = {
        "accepted": accepted,
        "sdpa_bf16_bias_err": float((fused.double() - exact).abs().max()) / scale,
        "plain_f32_bias_err": float((plain.double() - exact).abs().max()) / scale,
        "sdpa_ms": time_ms(vit_module._attention, q, k, v, bias),
        "plain_ms": time_ms(vit_module._attention_plain, q, k, v, bias),
    }
    log(f"attention at a global block ({batch}, {heads}, {tokens}, {dim}) bf16 with a float bias: {json.dumps(report)}")
    return report


def scan_ms(vim_module, batch, tokens=1025, channels=384, state=16):
    """Device ms of one Mamba layer's scan (both directions in one batch, float32), forward and
    backward, at the ViM-UNet step's shapes."""
    gen = card_generator(13)

    def rand(*shape, positive=False):
        t = torch.randn(*shape, generator=gen, device="cuda")
        return (torch.nn.functional.softplus(t) if positive else t).requires_grad_()

    u, delta = rand(2, batch, tokens, channels), rand(2, batch, tokens, channels, positive=True)
    A = (-torch.rand(2, 1, channels, state, generator=gen, device="cuda") - 0.5).requires_grad_()
    B, C = rand(2, batch, tokens, state), rand(2, batch, tokens, state)
    D = rand(2, 1, channels)
    g = torch.randn(2, batch, tokens, channels, generator=gen, device="cuda")

    def step():
        vim_module._selective_scan(u, delta, A, B, C, D).backward(g)

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    y = vim_module._selective_scan(u, delta, A, B, C, D)
    saved = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    del y
    kernels = profiled_kernels(step, 3)
    as_called = time_ms(step, iters=3, repeats=3)
    device = sum(kernels.values())
    log(f"one Mamba layer's scan, forward and backward, ({2}, {batch}, {tokens}, {channels}, {state}) float32: "
        f"{as_called:.2f} ms as called, {device:.2f} ms of {len(kernels)} distinct device kernels; "
        f"{saved:.2f} GiB held for the backward")
    return as_called, device, saved


def vit_recipe(port, inorm, label, factory_name, kwargs, raw_files, label_files, tmp):
    """One recipe model: CPU against card, training with resume, the step broken down, serving
    through both paths. Returns its numbers and the kernels' launches of training and serving."""
    from torch_em_tpu_torch.models import vim as vim_module, vit as vit_module
    from torch_em_tpu_torch.transforms import BoundaryTransform
    from torch_em_tpu_torch.utils import profiling
    from torch_em_tpu_torch.utils.test import make_image

    factory = getattr(port.models, factory_name)
    stats = {}
    gen = np.random.default_rng(11)
    inputs = [torch.from_numpy(gen.normal(size=(1, 1) + VIT_PATCH[1:]).astype(np.float32))]
    if label == "UNETR":
        inputs.append(torch.from_numpy(gen.normal(size=(1, 1, 448, 448)).astype(np.float32)))
    stats["cpu_vs_card"] = check_cpu_against_card(label, factory, kwargs, inputs)

    def loader(n_samples, shuffle):
        return port.default_segmentation_loader(
            raw_files[:-2] if shuffle else raw_files[-2:], None, label_files[:-2] if shuffle else label_files[-2:],
            None, batch_size=VIT_BATCH, patch_shape=VIT_PATCH, ndim=2, is_seg_dataset=False,
            label_transform=BoundaryTransform(add_binary_target=True), num_workers=LOADER_THREADS, shuffle=shuffle,
            n_samples=n_samples)

    model = factory(**kwargs, device="cuda", seed=0)
    skip = model.use_skip_connection  # the first norm then reads the input, which needs no gradient
    shapes = unetr_norm_shapes(model.encoder.embed_dim, skip)
    norms = (len(shapes), len(shapes) - 1 if skip else len(shapes))
    np.random.seed(12)
    torch.manual_seed(12)
    trainer = port.default_segmentation_trainer(
        label, model, loader(VIT_BATCH * VIT_FIT, True), loader(VIT_BATCH, False), learning_rate=LEARNING_RATE,
        device="cuda", mixed_precision=True, logger=LossLog, save_root=tmp)
    profile_dir = os.path.join(tmp, f"profile-{label}")
    resumed, launches = fit_and_resume(port, inorm, trainer, VIT_FIT, VIT_RESUME, 1, f"{label} recipe", norms=norms,
                                       profile_dir=profile_dir, log_mfu=True)
    traces = os.listdir(profile_dir)
    if not traces:
        raise AssertionError(f"{label}: fit(profile_dir=...) wrote no trace")
    flops = trainer._step_flops
    x, y = (v.cuda() for v in next(iter(loader(VIT_BATCH, False))))
    stats["step_ms_as_called"] = time_ms(resumed._train_step, x, y, iters=3, repeats=3)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(5):
        resumed._train_step(x, y)
    torch.cuda.synchronize()
    wall_s = (time.perf_counter() - t) / 5
    torch.cuda.reset_peak_memory_stats()
    resumed._train_step(x, y)
    torch.cuda.synchronize()
    stats["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    breakdown = device_breakdown(f"{label} training step (bf16 forward, backward, AdamW), batch {VIT_BATCH}",
                                 lambda: resumed._train_step(x, y), steps=1, top=12)
    kernels = breakdown.pop("kernels")
    attention = sum(ms for k, ms in kernels.items() if ATTENTION_KERNELS.search(k))
    stats.update(step_device_ms=breakdown["device_ms"], step_wall_ms=wall_s * 1e3,
                 device_idle=max(0.0, 1 - breakdown["device_ms"] / (wall_s * 1e3)),
                 norm_share=breakdown["norm_ms"] / breakdown["device_ms"],
                 conv_share=breakdown["conv_ms"] / breakdown["device_ms"],
                 attention_share=attention / sum(kernels.values()), step_gflop=flops / 1e9, traces=traces,
                 mfu_bare_step=profiling.mfu(flops, wall_s), sdpa_kernels=sorted(
                     {k[:60] for k in kernels if ATTENTION_KERNELS.search(k)}))
    if label == "UNETR":
        stats["sdpa"] = sdpa_report(vit_module, VIT_BATCH)
    else:
        as_called, device, saved = scan_ms(vim_module, VIT_BATCH)
        layers = len(resumed.model.encoder.layers)
        stats.update(scan_ms_per_layer=as_called, scan_device_ms_per_layer=device, scan_saved_gib_per_layer=saved,
                     scan_share=min(1.0, layers * device / breakdown["device_ms"]))
    log(f"{label} step: {stats['step_ms_as_called']:.2f} ms as called (CUDA events), {wall_s * 1e3:.2f} ms wall, "
        f"{breakdown['device_ms']:.2f} ms of device kernels (idle {stats['device_idle']:.1%}); {flops / 1e9:.1f} "
        f"GFLOP per step, MFU {stats['mfu_bare_step']:.2%} of the bf16 peak; peak memory "
        f"{stats['peak_memory_gib']:.2f} GiB; attention {stats['attention_share']:.1%}, norms "
        f"{stats['norm_share']:.1%} of the device time; {nvidia_smi()}")
    del x, y, trainer
    torch.cuda.empty_cache()

    network = resumed.model.eval()
    network.dtype = torch.bfloat16
    image = make_image(np.random.default_rng(14), max(VIT_SERVE))[0][:VIT_SERVE[0], :VIT_SERVE[1]]
    host, host_stats = serve(port, inorm, network, image, "host", block_shape=VIT_BLOCK, halo=VIT_HALO,
                             norms=norms[0])
    device, device_stats = serve(port, inorm, network, image, "device", block_shape=VIT_BLOCK, halo=VIT_HALO,
                                 norms=norms[0])
    # the paths reflect-pad a partial edge block differently (the host path per block, the device path the
    # whole image once; utils/prediction.py:_predict_on_device), and a global attention spreads that over the
    # whole block: they are compared over the full blocks
    full = (slice(None),) + tuple(slice(0, s // b * b) for s, b in zip(VIT_SERVE, VIT_BLOCK))
    check_close(f"{label} {VIT_SERVE}: device-resident path vs host path over the full blocks {host[full].shape}",
                device[full], host[full])
    edge = np.abs(device - host)
    edge[full] = 0
    log(f"{label}: the partial edge blocks differ between the paths by up to {float(edge.max()):.3g}")
    stats["serving"] = [host_stats, device_stats]
    log(f"{label}: {json.dumps(stats)}")
    del resumed, network, host, device
    torch.cuda.empty_cache()
    return launches[0] + host_stats["launches"] + device_stats["launches"], launches[1]


def phase_vit_recipes(port, inorm, raw_files, label_files):
    """The ViM-UNet / UNETR recipe on the LIVECell-sized images (``livecell_images``): both
    models at full width (CPU against card, training with resume, the step broken down,
    serving), then UNETR3D at a small size against the CPU. Returns the kernels' launches of
    the two models' training and serving."""
    fwd = bwd = 0
    with tempfile.TemporaryDirectory() as tmp:
        for label, factory_name, kwargs in VIT_RECIPES:
            f, b = vit_recipe(port, inorm, label, factory_name, kwargs, raw_files, label_files, tmp)
            fwd, bwd = fwd + f, bwd + b
    x = torch.from_numpy(np.random.default_rng(15).normal(size=(1, 1, 4, 64, 64)).astype(np.float32))
    cpu_model = port.models.UNETR3D(**UNETR3D_SMALL, device="cpu", seed=0)
    card_model = port.models.UNETR3D(**UNETR3D_SMALL, device="cuda", seed=0)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            expected, got = cpu_model(x), card_model(x.cuda()).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    err = float((got - expected).abs().max() / expected.abs().max())
    log(f"UNETR3D {tuple(x.shape)} float32 (TF32 off), card against CPU: max err {err:.3g} of the largest output "
        f"(limit {VIT_FEATURE_RTOL})")
    if got.shape != (1, 2, 4, 64, 64) or not err <= VIT_FEATURE_RTOL:
        raise AssertionError(f"UNETR3D on the card disagrees with the CPU: {err}")
    return fwd, bwd


class SelfTrainingLog:
    """LossLog for the self-training trainers: a step's loss is its combined loss where there is
    one (semi-supervised), else its unsupervised loss; one metric per validation."""

    def __init__(self, trainer, save_root, **kwargs):
        self.by_step, self.metrics = {}, []

    @property
    def losses(self):
        return list(self.by_step.values())

    def log_train(self, step, loss, lr, x, y, prediction, log_gradients=False):
        self.by_step[step] = loss

    def log_train_unsupervised(self, step, loss, *args):
        self.by_step.setdefault(step, loss)

    def log_combined_loss(self, step, loss):
        self.by_step[step] = loss

    def log_train_supervised(self, *args):
        pass

    def log_lr(self, *args):
        pass

    def log_ct(self, *args):
        pass

    def log_validation(self, step, metric, *args):
        self.metrics.append(metric)

    log_validation_supervised = log_validation_unsupervised = log_validation


def check_augmenters(port, shape):
    """The invertible augmenters on the card: each of the 16 geometric draws of the weak augmenter
    undone bitwise; the strong augmenter's blur and noise with given parameters against the CPU."""
    from torch_em_tpu_torch.transforms.invertible_augmentations import InvertibleAugmenter

    x = card_rand(card_generator(20), shape, torch.float32)
    weak, strong = InvertibleAugmenter("weak"), InvertibleAugmenter("strong")
    for k in (-1, 0, 1, 2):
        for hflip in (False, True):
            for vflip in (False, True):
                params = {"hflip": hflip, "vflip": vflip, "k": k}
                if not torch.equal(weak.inverse(weak.apply(x, params), params), x):
                    raise AssertionError(f"the weak augmenter's inverse does not undo {params} on the card")
    noise = torch.randn(shape, generator=torch.Generator().manual_seed(21)) * strong.noise_std
    err = 0.0
    for sigma in (1e-4, 0.1, 0.55, 1.0):
        params = {"hflip": True, "vflip": False, "k": -1, "sigma": sigma, "noise": noise}
        got = strong.apply(x, {**params, "noise": noise.cuda()}).cpu()
        expected = strong.apply(x.cpu(), params)
        err = max(err, float((got - expected).abs().max()))
    draws = [strong.draw(x, torch.Generator().manual_seed(s), card_generator(s)) for s in range(8)]
    if not (err <= ST_AUG_ATOL and all(d["noise"] is None or d["noise"].device == x.device for d in draws)):
        raise AssertionError(f"the strong augmenter on the card differs from the CPU by {err}")
    log(f"invertible augmenters on the card, {shape}: 16 geometric draws undone bitwise; blur and noise with "
        f"given parameters {err:.3g} from the CPU (limit {ST_AUG_ATOL}); noise drawn on the card")


def check_pseudo_labels(st, teacher_out, align):
    """Pseudo-labels and masks of a teacher output on the card equal the CPU's; so does FixMatch's
    distribution alignment (``align``, a trainer's), within float32 rounding."""
    cpu_out = teacher_out.cpu()
    for labeler in (st.DefaultPseudoLabeler(confidence_threshold=ST_CT),
                    st.DefaultPseudoLabeler(confidence_threshold=ST_CT, mask_channel=1),
                    st.DefaultPseudoLabeler(confidence_threshold=ST_CT, threshold_from_both_sides=False)):
        card, cpu = labeler(lambda t: t, teacher_out), labeler(lambda t: t, cpu_out)
        if not all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu)):
            raise AssertionError(f"pseudo-labels of {labeler.init_kwargs} on the card differ from the CPU's")
    aligned, expected = align(teacher_out).cpu(), align(cpu_out)
    if not torch.allclose(aligned, expected, rtol=1e-6, atol=1e-7):
        raise AssertionError("FixMatch's distribution alignment on the card differs from the CPU's")
    share = float(st.DefaultPseudoLabeler(confidence_threshold=ST_CT)(lambda t: t, teacher_out)[1].mean())
    log(f"pseudo-labels of a teacher output {tuple(teacher_out.shape)}: labels and masks equal to the CPU's "
        f"(both sides, mask channel, one side), {share:.1%} of the pixels confident at {ST_CT}; "
        f"the distribution alignment within float32 rounding")


def check_punet(port, batch):
    """The Probabilistic U-Net at its defaults, float32 with TF32 off: the forward and the ELBO on the
    card, with a given noise draw, against the CPU from the same seed."""
    x, y = batch[0][:PUNET_CHECK_BATCH].float().cpu(), batch[1][:PUNET_CHECK_BATCH].float().cpu()
    cpu_model = port.models.ProbabilisticUNet(device="cpu", seed=0)
    card_model = port.models.ProbabilisticUNet(device="cuda", seed=0)
    noise = torch.randn(x.shape[0], 6, generator=torch.Generator().manual_seed(22))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            expected = (cpu_model(x), cpu_model.elbo(x, y, noise=noise))
            got = (card_model(x.cuda()).cpu(), card_model.elbo(x.cuda(), y.cuda(), noise=noise.cuda()).cpu())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    errs = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, expected)]
    log(f"Probabilistic U-Net {tuple(x.shape)} float32 (TF32 off), card against CPU: forward {errs[0]:.3g}, "
        f"ELBO {errs[1]:.3g} of the largest value ({float(expected[1]):.1f}; limit {PUNET_RTOL})")
    if got[0].shape != x.shape or not max(errs) <= PUNET_RTOL:
        raise AssertionError(f"the Probabilistic U-Net on the card disagrees with the CPU: {errs}")
    return errs


def st_step_report(label, trainer, batch, fit_flops, teacher=None):
    """The bare step on a device-resident batch: as called (CUDA events), wall, device (profiler), idle,
    peak memory, FLOPs and MFU, the top kernels with the norms' share and (``teacher``, a callable) the
    teacher forward's; ``fit_flops`` is what ``fit(log_mfu=True)`` counted."""
    from torch_em_tpu_torch.utils import profiling

    def step():
        trainer._train_step(*batch)

    stats = {"step_ms_as_called": time_ms(step, iters=5, repeats=3)}
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    wall_s = (time.perf_counter() - t) / 5
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    stats["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    flops = profiling.estimate_step_flops(step)
    breakdown = device_breakdown(f"{label} training step", step)
    device = breakdown["device_ms"]
    stats.update(step_wall_ms=wall_s * 1e3, step_device_ms=device, device_idle=max(0.0, 1 - device / (wall_s * 1e3)),
                 norm_share=breakdown["norm_ms"] / device, conv_share=breakdown["conv_ms"] / device,
                 step_gflop=flops / 1e9, fit_gflop=fit_flops / 1e9, mfu=profiling.mfu(flops, wall_s))
    if teacher is not None:
        with torch.no_grad():
            stats["teacher_ms"] = sum(profiled_kernels(teacher, 2).values())
        stats["teacher_share"] = stats["teacher_ms"] / device
    log(f"{label} step: {stats['step_ms_as_called']:.2f} ms as called (CUDA events), {wall_s * 1e3:.2f} ms wall, "
        f"{device:.2f} ms of device kernels (idle {stats['device_idle']:.1%}); {flops / 1e9:.1f} GFLOP, MFU "
        f"{'not known' if stats['mfu'] is None else format(stats['mfu'], '.2%')}; peak memory "
        f"{stats['peak_memory_gib']:.2f} GiB; norms {stats['norm_share']:.1%}"
        + ("" if teacher is None else f", the teacher's forward {stats['teacher_share']:.1%}")
        + f" of the device time; {nvidia_smi()}")
    return stats


def phase_self_training(port, inorm):
    """Self-training at DSB width: MeanTeacher (unsupervised; semi-supervised with a fresh teacher),
    FixMatch with its augmenters, UniMatch v2, the Probabilistic U-Net at its defaults and the bf16
    FlashOptimTrainer, each fitted, resumed from its checkpoint and its bare step measured; the
    moving average, the augmenters, the pseudo-labels and the Probabilistic U-Net on the card against
    the CPU. Returns the kernels' launches of the six fits."""
    from torch_em_tpu_torch import self_training as st
    from torch_em_tpu_torch.data import RawImageCollectionDataset
    from torch_em_tpu_torch.transforms import BoundaryTransform, get_default_mean_teacher_augmentations

    check_augmenters(port, (DSB_BATCH,) + DSB_PATCH)
    stats, launches = {}, [0, 0]
    adamw = port.OptimizerSpec("adamw", lr=LEARNING_RATE)
    with tempfile.TemporaryDirectory() as tmp:
        raw_files, label_files = dsb_images(tmp)
        views = get_default_mean_teacher_augmentations()
        binary = port.transforms.labels_to_binary

        def labelled(n_samples, shuffle=True, label_transform=BoundaryTransform(add_binary_target=True)):
            return port.default_segmentation_loader(
                raw_files, None, label_files, None, batch_size=DSB_BATCH, patch_shape=DSB_PATCH, ndim=2,
                is_seg_dataset=False, label_transform=label_transform, num_workers=LOADER_THREADS, shuffle=shuffle,
                n_samples=n_samples)

        def unlabelled(n_samples, shuffle=True):
            dataset = RawImageCollectionDataset(raw_files, DSB_PATCH[1:], augmentations=(views, views),
                                                n_samples=n_samples)
            return port.DataLoader(dataset, batch_size=DSB_BATCH, shuffle=shuffle, num_workers=LOADER_THREADS)

        unsupervised = dict(
            unsupervised_train_loader=unlabelled(DSB_BATCH * ST_FIT),
            unsupervised_val_loader=unlabelled(DSB_BATCH, False), unsupervised_loss=st.DefaultSelfTrainingLoss(),
            unsupervised_loss_and_metric=st.DefaultSelfTrainingLossAndMetric(),
            pseudo_labeler=st.DefaultPseudoLabeler(confidence_threshold=ST_CT))
        common = dict(optimizer=adamw, mixed_precision=True, device="cuda", logger=SelfTrainingLog, save_root=tmp)
        teacher_batch = next(iter(unlabelled(DSB_BATCH, False)))[0].cuda()
        recipes = [
            # label, the trainer's class and arguments, fit_and_resume's counts (forwards per step and per
            # validation batch, backward passes per step) and whether the loss must fall: the supervised losses
            # must, the unsupervised ones chase a moving teacher and are held finite. The semi-supervised run
            # comes first: its student,
            # trained on the labelled source, starts the unsupervised adaptations, as a user adapts a network
            # to a target that has no labels
            ("MeanTeacher semi-supervised", st.MeanTeacherTrainer, dict(
                name="mean_teacher_semi", reinit_teacher=True, supervised_train_loader=labelled(DSB_BATCH * ST_FIT),
                supervised_val_loader=labelled(DSB_BATCH, False), supervised_loss=st.DefaultSelfTrainingLoss(),
                supervised_loss_and_metric=st.DefaultSelfTrainingLossAndMetric(),
                **{k: v for k, v in unsupervised.items() if k != "unsupervised_val_loader"}),
             dict(forwards=3, val_forwards=1, backwards=2)),
            ("MeanTeacher", st.MeanTeacherTrainer, dict(name="mean_teacher", **unsupervised),
             dict(forwards=2, falling=False)),
            ("FixMatch", st.FixMatchTrainerWithInvertibleAugmentations, dict(
                name="fix_match", augmenter=st.FixMatchAugmenters(ndim=2), **unsupervised),
             dict(forwards=2, falling=False)),
            ("UniMatch v2", st.UniMatchv2Trainer, dict(
                name="unimatch", augmenter=st.UniMatchv2Augmenters(ndim=2),
                **{**unsupervised, "unsupervised_loss": st.DefaultUnimatchLoss(),
                   "unsupervised_loss_and_metric": st.DefaultUnimatchLossAndMetric()}),
             dict(forwards=2, falling=False)),
            ("Probabilistic U-Net", st.ProbabilisticUNetTrainer, dict(
                name="punet", model=None, train_loader=labelled(DSB_BATCH * ST_FIT, label_transform=binary),
                val_loader=labelled(DSB_BATCH, False, label_transform=binary), loss=st.ProbabilisticUNetLoss(),
                loss_and_metric=st.ProbabilisticUNetLossAndMetric(prior_samples=PUNET_PRIOR_SAMPLES)), dict()),
            ("FlashOptim", port.trainer.FlashOptimTrainer, dict(
                name="flashoptim", train_loader=labelled(DSB_BATCH * ST_FIT), val_loader=labelled(DSB_BATCH, False),
                loss=port.DiceLoss(), metric=port.DiceLoss()), dict()),
        ]
        source = None
        for label, trainer_class, kwargs, counts in recipes:
            np.random.seed(13)
            torch.manual_seed(13)
            model = port.UNet2d(**DSB_MODEL, depth=DSB_DEPTH, device="cuda", seed=0) if "model" not in kwargs \
                else port.models.ProbabilisticUNet(device="cuda", seed=0)
            if "pseudo_labeler" in kwargs and source is not None:
                model.load_state_dict(source)
            trainer = trainer_class(**{**kwargs, "model": model}, **common)

            def teacher_restored(resumed, trainer=trainer, label=label):
                if getattr(trainer, "teacher", None) is None:
                    return
                saved = torch.load(os.path.join(trainer.checkpoint_folder, "latest.ckpt"), map_location="cpu",
                                   weights_only=True)["teacher_state"]
                restored = resumed.teacher.state_dict()
                if not (type(resumed) is type(trainer) and restored.keys() == saved.keys()
                        and all(torch.equal(restored[k].cpu(), saved[k]) for k in saved)):
                    raise AssertionError(f"{label}: from_checkpoint did not restore the teacher bitwise")
                log(f"{label}: from_checkpoint restored the teacher bitwise ({len(saved)} tensors)")

            initial = {k: v.detach().to(torch.bfloat16).clone() for k, v in model.named_parameters()}
            resumed, (fwd, bwd) = fit_and_resume(port, inorm, trainer, ST_FIT, ST_RESUME, 1, label,
                                                 check_resumed=teacher_restored, log_mfu=True, **counts)
            # the share of the weights that the fit and the resume moved from their initial bf16 values; in
            # FlashOptim's bf16 parameters, an AdamW step of about lr is below half an ulp of every weight
            # with |w| >= 2^-5, which then never moves, but most of the network's weights are smaller
            after = dict(resumed.model.named_parameters())
            moved = sum(int((after[k].to(torch.bfloat16) != v).sum()) for k, v in initial.items()) / \
                sum(v.numel() for v in initial.values())
            log(f"{label}: {moved:.1%} of the weights moved from their initial bf16 values")
            if not moved > 0.5:
                raise AssertionError(f"{label}: only {moved:.1%} of the weights moved in {ST_FIT + ST_RESUME} steps")
            del initial, after
            launches[0] += fwd
            launches[1] += bwd
            if label == "MeanTeacher semi-supervised":
                source = {k: v.detach().clone() for k, v in resumed.model.state_dict().items()}
            teacher = getattr(resumed, "_teacher_forward", None)
            batch = next(resumed._train_batches())
            stats[label] = st_step_report(label, resumed, batch, trainer._step_flops,
                                          None if teacher is None else lambda: teacher(teacher_batch))
            stats[label]["moved_share"] = moved
            if teacher is not None:
                with torch.no_grad():
                    labels = resumed._pseudo_labels(teacher_batch)
                stats[label]["confident_share"] = float(labels[1].mean())
                log(f"{label}: {stats[label]['confident_share']:.1%} of the pseudo-labels confident at {ST_CT}")
            if label == "MeanTeacher":
                check_ema(resumed.teacher, resumed.model, resumed.ema_update,
                          float(np.float32(resumed._current_momentum())), stats[label])
            elif label == "FixMatch":
                with torch.no_grad():
                    check_pseudo_labels(st, teacher(teacher_batch), resumed._distribution_alignment)
            elif label == "Probabilistic U-Net":
                stats[label]["card_against_cpu"] = check_punet(port, batch)
            elif label == "FlashOptim":
                moments = {v.dtype for s in resumed.torch_optimizer.state.values() for k, v in s.items() if k != "step"}
                params = {p.dtype for p in resumed.model.parameters()}
                if params != {torch.bfloat16} or moments != {torch.bfloat16}:
                    raise AssertionError(f"FlashOptim: parameters {params}, AdamW moments {moments}")
                log("FlashOptim: parameters and AdamW moments are bfloat16 after the fit and the resume")
            shutil.rmtree(trainer.checkpoint_folder)
            del trainer, resumed, batch, teacher, model
            torch.cuda.empty_cache()
        log(f"self-training: {json.dumps(stats)}")
    return launches


def family_norm_shapes(kwargs, channels, grid):
    """The instance norms of one forward of an encoder family's UNETR (``FAMILY_RECIPES``)."""
    return unetr_norm_shapes(channels, kwargs.get("use_skip_connection", True), size=kwargs["img_size"], grid=grid)


def family_cpu_check(port, name, kwargs):
    """The family's UNETR at a reduced depth and size (``FAMILY_SMALL``) from one seed on the CPU
    and on the card, float32 with TF32 off: the same weights, outputs and encoder features
    within FAMILY_CPU_RTOL of their largest value."""
    small = dict(kwargs, **FAMILY_COMMON, **FAMILY_SMALL[name])
    cpu_model = port.models.UNETR(**small, device="cpu", seed=0)
    card_model = port.models.UNETR(**small, device="cuda", seed=0)
    card_state = card_model.state_dict()
    if not all(torch.equal(v, card_state[k].cpu()) for k, v in cpu_model.state_dict().items()):
        raise AssertionError(f"{name}: the same seed gave other weights on the card")
    size = small["img_size"]
    x = torch.from_numpy(np.random.default_rng(17).normal(size=(1, 1, size, size)).astype(np.float32))
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            errors = {}
            pairs = [("output", cpu_model(x), card_model(x.cuda()).cpu())]
            x3 = x.repeat(1, 3, 1, 1)
            pairs.append(("features", cpu_model.encoder(x3)[0], card_model.encoder(x3.cuda())[0].cpu()))
            for what, expected, got in pairs:
                err = float((got - expected).abs().max() / expected.abs().max())
                errors[what] = err
                if got.shape != expected.shape or not bool(torch.isfinite(got).all()) or not err <= FAMILY_CPU_RTOL:
                    raise AssertionError(f"{name} {what}: card against CPU {err} of the largest value")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    log(f"{name} at {size}x{size}, {json.dumps(FAMILY_SMALL[name])}: float32 (TF32 off) card against CPU "
        f"{json.dumps(errors)} of the largest value (limit {FAMILY_CPU_RTOL})")
    del cpu_model, card_model
    torch.cuda.empty_cache()
    return errors


def family_step(port, inorm, name, trainer, x, y, shapes, skip):
    """One bf16 training step of ``trainer`` on the card batch (x, y), its kernels' launches
    counted from 0 (every norm forward, all but the input's backward), timed as called and on
    the device, profiled (attention, norm, conv shares, idle), its FLOPs, MFU and peak memory;
    then one bf16 forward under inference_mode, checked and counted. Returns its numbers and
    the launches (forward, backward) of the counted step and forward."""
    from torch_em_tpu_torch.utils import profiling

    def step():
        return trainer._train_step(x, y)

    step()  # cuDNN's first calls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    inorm.instance_norm.launches = inorm.instance_norm_backward.launches = 0
    loss, _ = step()
    torch.cuda.synchronize()
    launches = [inorm.instance_norm.launches, inorm.instance_norm_backward.launches]
    expected = (len(shapes), len(shapes) - 1 if skip else len(shapes))
    if tuple(launches) != expected or not bool(torch.isfinite(loss)):
        raise AssertionError(f"{name} step: launches {launches}, expected {expected}; loss {float(loss)}")
    stats = {"batch": list(x.shape), "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    # three steps back to back: as called between CUDA events, and on the host's clock
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    for _ in range(3):
        step()
    stop.record()
    torch.cuda.synchronize()
    wall_s = (time.perf_counter() - t) / 3
    stats["step_ms_as_called"] = start.elapsed_time(stop) / 3
    flops = profiling.estimate_step_flops(step) or 0.0
    kernels = profiled_kernels(step, 1)
    device = sum(kernels.values())
    if device == 0:
        raise AssertionError(f"{name}: the profiler shows no device time")
    attention = sum(ms for k, ms in kernels.items() if ATTENTION_KERNELS.search(k))
    norms = sum(ms for k, ms in kernels.items() if NORM_KERNELS.search(k))
    convs = sum(ms for k, ms in kernels.items() if CONV_KERNELS.search(k) and not NORM_KERNELS.search(k))
    stats.update(step_device_ms=device, step_wall_ms=wall_s * 1e3, device_idle=max(0.0, 1 - device / (wall_s * 1e3)),
                 attention_share=attention / device, norm_share=norms / device, conv_share=convs / device,
                 step_gflop=flops / 1e9, mfu=profiling.mfu(flops, wall_s),
                 top=[(k[:70], round(ms, 3)) for k, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:6]])

    model = trainer.model.eval()
    model.dtype = torch.bfloat16
    inorm.instance_norm.launches = 0
    with torch.inference_mode():
        out = model(x)
        torch.cuda.synchronize()
        launches[0] += inorm.instance_norm.launches
        if inorm.instance_norm.launches != len(shapes):
            raise AssertionError(f"{name} forward: {inorm.instance_norm.launches} launches, expected {len(shapes)}")
        if out.shape != (x.shape[0], 2) + tuple(x.shape[2:]) or not bool(torch.isfinite(out).all()) or \
                float(out.min()) < 0 or float(out.max()) > 1:
            raise AssertionError(f"{name} forward: {tuple(out.shape)}, range [{float(out.min())}, {float(out.max())}]")
        stats["forward_ms_as_called"] = time_ms(model, x, iters=2, repeats=1)
    model.dtype = torch.float32
    mfu = "not known" if stats["mfu"] is None else f"{stats['mfu']:.2%}"
    log(f"{name} step {tuple(x.shape)}: {stats['step_ms_as_called']:.2f} ms as called, {wall_s * 1e3:.2f} ms wall, "
        f"{device:.2f} ms of device kernels (idle {stats['device_idle']:.1%}); {flops / 1e9:.1f} GFLOP, MFU {mfu}; "
        f"peak {stats['peak_memory_gib']:.2f} GiB; attention {stats['attention_share']:.1%}, norms "
        f"{stats['norm_share']:.1%}, convs {stats['conv_share']:.1%}; bf16 forward {stats['forward_ms_as_called']:.2f} "
        f"ms; {nvidia_smi()}")
    return stats, launches


def family_recipe(port, inorm, name, kwargs, batch, shapes, raw_files, label_files, tmp):
    """One encoder family at full width: CPU against card at a reduced size; for FAMILY_ENTRY
    ``default_segmentation_trainer`` fit, ``from_checkpoint`` and a resumed fit (the weights
    move), else a trainer built for the bare step; the step and a forward (``family_step``);
    for FAMILY_ENTRY serving 1536x1536 through both paths. Returns its numbers and launches."""
    from torch_em_tpu_torch.transforms import BoundaryTransform

    stats = {"cpu_vs_card": family_cpu_check(port, name, kwargs)}
    skip = kwargs.get("use_skip_connection", True)

    def loader(n_samples, shuffle):
        return port.default_segmentation_loader(
            raw_files[:-2] if shuffle else raw_files[-2:], None, label_files[:-2] if shuffle else label_files[-2:],
            None, batch_size=batch, patch_shape=VIT_PATCH, ndim=2, is_seg_dataset=False,
            label_transform=BoundaryTransform(add_binary_target=True), num_workers=LOADER_THREADS, shuffle=shuffle,
            n_samples=n_samples)

    t = time.perf_counter()
    model = port.models.UNETR(**kwargs, **FAMILY_COMMON, device="cuda", seed=0)
    stats["build_s"] = time.perf_counter() - t
    np.random.seed(18)
    torch.manual_seed(18)
    trainer = port.default_segmentation_trainer(
        name, model, loader(batch * FAMILY_FIT, True), loader(batch, False), learning_rate=LEARNING_RATE,
        device="cuda", mixed_precision=True, logger=LossLog, save_root=tmp)
    launches = [0, 0]
    if name in FAMILY_ENTRY:
        start = {k: p.detach().clone() for k, p in model.named_parameters()}
        norms = (len(shapes), len(shapes) - 1 if skip else len(shapes))
        trainer, fit_launches = fit_and_resume(port, inorm, trainer, FAMILY_FIT, FAMILY_RESUME, 1,
                                               f"{name} entry points", norms=norms)
        launches = list(fit_launches)
        moved = sum(int((p.detach() != start[k]).sum()) for k, p in trainer.model.named_parameters())
        total = sum(v.numel() for v in start.values())
        stats["weights_moved"] = moved / total
        log(f"{name}: {moved / total:.1%} of the {total} weights moved in {FAMILY_FIT + FAMILY_RESUME} steps")
        if not moved / total > 0.5:
            raise AssertionError(f"{name}: only {moved / total:.1%} of the weights moved")
        shutil.rmtree(trainer.checkpoint_folder)
        del start
    else:
        trainer._build_optimizer()
    x, y = (v.cuda() for v in next(iter(loader(batch, False))))
    step_stats, step_launches = family_step(port, inorm, name, trainer, x, y, shapes, skip)
    stats.update(step_stats)
    launches = [a + b for a, b in zip(launches, step_launches)]
    del x, y
    torch.cuda.empty_cache()

    if name in FAMILY_ENTRY:
        from torch_em_tpu_torch.utils.test import make_image

        network = trainer.model.eval()
        network.dtype = torch.bfloat16
        image = make_image(np.random.default_rng(14), max(VIT_SERVE))[0][:VIT_SERVE[0], :VIT_SERVE[1]]
        host, host_stats = serve(port, inorm, network, image, "host", block_shape=VIT_BLOCK, halo=VIT_HALO,
                                 norms=len(shapes))
        device, device_stats = serve(port, inorm, network, image, "device", block_shape=VIT_BLOCK, halo=VIT_HALO,
                                     norms=len(shapes))
        full = (slice(None),) + tuple(slice(0, s // b * b) for s, b in zip(VIT_SERVE, VIT_BLOCK))
        check_close(f"{name} {VIT_SERVE}: device-resident path vs host path over the full blocks",
                    device[full], host[full])
        stats["serving"] = [host_stats, device_stats]
        launches[0] += host_stats["launches"] + device_stats["launches"]
        del host, device
    log(f"{name}: {json.dumps(stats)}")
    del trainer, model
    torch.cuda.empty_cache()
    return stats, launches


def classification_volumes(n, seed):
    """``n`` seeded volumes CLS_SHAPE of classes 0..CLS_CLASSES-1 in turn: normal noise smoothed
    with a Gaussian of sigma 0.5 + class, one (n, *CLS_SHAPE) float32 array, and the labels."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    labels = np.arange(n) % CLS_CLASSES
    data = np.stack([ndimage.gaussian_filter(rng.normal(size=CLS_SHAPE).astype(np.float32), (0, 0.5 + k, 0.5 + k,
                                                                                            0.5 + k))
                     for k in labels])
    return data, labels


def phase_classification(port, tmp):
    """resnet3d_50(1, 4) through ``default_classification_loader`` and
    ``default_classification_trainer(logger=None)``: fit, ``from_checkpoint``, resumed fit (the
    weights move, the accuracy error from the numpy metric lies in [0, 1]), then the bare step
    timed as called and on the device, its MFU and peak memory."""
    from torch_em_tpu_torch.utils import profiling

    cls = port.classification
    train_data, train_labels = classification_volumes(CLS_TRAIN, 19)
    val_data, val_labels = classification_volumes(CLS_VAL, 20)
    train = cls.default_classification_loader(train_data, train_labels, batch_size=CLS_BATCH, shuffle=True,
                                              num_workers=LOADER_THREADS)
    val = cls.default_classification_loader(val_data, val_labels, batch_size=CLS_BATCH, num_workers=LOADER_THREADS)
    model = port.resnet3d_50(1, CLS_CLASSES)
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    trainer = cls.default_classification_trainer("resnet3d_50", model, train, val, logger=None, learning_rate=1e-3,
                                                 save_root=tmp)
    t = time.perf_counter()
    trainer.fit(iterations=CLS_FIT)
    fit_s = time.perf_counter() - t
    first_metric = trainer.current_metric
    resumed = port.DefaultTrainer.from_checkpoint(trainer.checkpoint_folder, "latest")
    if type(resumed) is not cls.ClassificationTrainer or resumed.iteration != CLS_FIT:
        raise AssertionError(f"classification: rebuilt {type(resumed)} at iteration {resumed.iteration}")
    resumed.fit(iterations=CLS_RESUME)
    moved = sum(int((p.detach() != start[k]).sum()) for k, p in resumed.model.named_parameters())
    total = sum(v.numel() for v in start.values())
    metric = resumed.current_metric
    if resumed.iteration != CLS_FIT + CLS_RESUME or not 0.0 <= metric <= 1.0 or not moved / total > 0.5:
        raise AssertionError(f"classification: iteration {resumed.iteration}, metric {metric}, moved {moved / total}")
    x, y = (v.cuda() for v in next(iter(val)))

    def step():
        return resumed._train_step(x, y)

    step()
    stats = {"fit_s": fit_s, "accuracy_error_after_fit": first_metric, "accuracy_error_after_resume": metric,
             "weights_moved": moved / total, "step_ms_as_called": time_ms(step, iters=3, repeats=3)}
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    wall_s = (time.perf_counter() - t) / 3
    torch.cuda.reset_peak_memory_stats()
    loss, _ = step()
    torch.cuda.synchronize()
    flops = profiling.estimate_step_flops(step) or 0.0
    device = sum(profiled_kernels(step, 1).values())
    stats.update(loss=float(loss), peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 step_wall_ms=wall_s * 1e3, step_device_ms=device, device_idle=max(0.0, 1 - device / (wall_s * 1e3)), step_gflop=flops / 1e9,
                 mfu=profiling.mfu(flops, wall_s))
    if not np.isfinite(stats["loss"]):
        raise AssertionError(f"classification: the loss {stats['loss']} is not finite")
    log(f"resnet3d_50 classification {tuple(x.shape)}: accuracy error {first_metric:.3f} after {CLS_FIT} steps, "
        f"{metric:.3f} after {CLS_RESUME} more (numpy metric); {moved / total:.1%} of the weights moved; step "
        f"{stats['step_ms_as_called']:.2f} ms as called, {device:.2f} ms device, {flops / 1e9:.1f} GFLOP, MFU "
        f"{stats['mfu'] if stats['mfu'] is None else format(stats['mfu'], '.2%')}, peak "
        f"{stats['peak_memory_gib']:.2f} GiB; {json.dumps(stats)}")
    shutil.rmtree(trainer.checkpoint_folder)
    del trainer, resumed, model, x, y, start
    torch.cuda.empty_cache()
    return stats


def phase_encoder_families(port, inorm, raw_files, label_files):
    """The other encoder families in UNETR (``family_recipe`` for each of FAMILY_RECIPES, on
    phase 12's images) and the 3-D ResNet classification; returns the kernels' launches
    (forward, backward)."""
    launches = [0, 0]
    with tempfile.TemporaryDirectory() as tmp:
        for name, kwargs, batch, channels, grid in FAMILY_RECIPES:
            _, family_launches = family_recipe(port, inorm, name, kwargs, batch,
                                               family_norm_shapes(kwargs, channels, grid), raw_files, label_files,
                                               tmp)
            launches = [a + b for a, b in zip(launches, family_launches)]
        phase_classification(port, tmp)
    return launches


class ArrayPairs:
    """(x[i], y[i]) of two arrays: a loader whose batches the phase fixes."""

    def __init__(self, x, y):
        self.x, self.y = x, y

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def md_loader(folder, n_samples, shuffle):
    """Phase 6's loader over the training volume's ``.npy`` files in ``folder`` (built in each
    process of train_multi_gpu)."""
    import torch_em_tpu_torch as port

    ds = port.SegmentationDataset(os.path.join(folder, "raw.npy"), None, os.path.join(folder, "labels.npy"), None,
                                  patch_shape=TRAIN_PATCH, n_samples=n_samples, raw_transform=port.standardize)
    return port.DataLoader(ds, batch_size=1, shuffle=shuffle, num_workers=LOADER_THREADS)


class ReportingTrainer:
    """train_multi_gpu's trainer_callable: ``default_segmentation_trainer`` whose ``fit`` writes the
    norm kernels' launches, the wall time and the peak memory of the process to ``path``."""

    def __init__(self, path):
        self.path = path

    def __call__(self, **kwargs):
        import torch_em_tpu_torch as port
        import torch_em_tpu_torch.ops.instance_norm as inorm

        trainer = port.default_segmentation_trainer(**kwargs)
        fit = trainer.fit

        def fit_and_report(*args, **fit_kwargs):
            torch.cuda.synchronize()
            inorm.instance_norm.launches = inorm.instance_norm_backward.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            fit(*args, **fit_kwargs)
            torch.cuda.synchronize()
            with open(self.path, "w") as f:
                json.dump({"rank": trainer.rank, "iteration": trainer.iteration, "seconds": time.perf_counter() - t,
                           "launches": [inorm.instance_norm.launches, inorm.instance_norm_backward.launches],
                           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                           "metric": trainer.current_metric}, f)

        trainer.fit = fit_and_report
        return trainer


def deterministic_f32():
    """Float32 without TF32, deterministic cuDNN; returns the previous settings for ``restore``."""
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    return old


def restore(old):
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = old


def md_dp_trainer(port, model, x, y, folder, trainer_class, mixed_precision=False, optimizer=None):
    loader = port.DataLoader(ArrayPairs(x, y), batch_size=len(x))
    return trainer_class(
        name="md-step", model=model, train_loader=loader, val_loader=loader, loss=port.DiceLoss(),
        metric=port.DiceLoss(), optimizer=optimizer or port.OptimizerSpec("sgd", lr=MD_DP_LR),
        mixed_precision=mixed_precision, device="cuda", logger=None, save_root=folder)


def md_timed(fn, n):
    """(ms per call as called, ms per call between CUDA events) of ``n`` calls after one more."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e3, start.elapsed_time(stop) / n


def md_worker(rank, world, store, folder):
    """One of the processes of 15b, sharing the card with the others over gloo; writes its report
    (and rank 0 its results) to ``folder``."""
    import torch.distributed as dist

    import torch_em_tpu_torch as port
    import torch_em_tpu_torch.models.unet as unet_module
    import torch_em_tpu_torch.ops.instance_norm as inorm
    from torch_em_tpu_torch.parallel import (get_mesh, halo_sharded_predict, init_process_group, shard_batch,
                                             spatial_sharded_train_step)
    from torch_em_tpu_torch.parallel.data_parallel import DataParallelTrainer
    from torch_em_tpu_torch.parallel.halo import _extend, receptive_field_halo

    init_process_group(f"file://{store}", world, rank, device="cuda", backend="gloo")
    report = {"rank": rank}
    try:
        inorm.instance_norm.launches = inorm.instance_norm_backward.launches = 0
        # one data-parallel step in float32 on this process's patch
        x, y = np.load(os.path.join(folder, "dp_x.npy")), np.load(os.path.join(folder, "dp_y.npy"))
        old = deterministic_f32()
        model = port.AnisotropicUNet(**TRACKED, dtype=torch.float32, device="cuda", seed=1)
        trainer = md_dp_trainer(port, model, x, y, os.path.join(folder, f"rank{rank}"), DataParallelTrainer)
        trainer._initialize(1, None)
        trainer.model.train()
        xl, yl = (t.cuda() for t in shard_batch((torch.from_numpy(x), torch.from_numpy(y)), trainer.mesh))
        loss, _ = trainer._train_step(xl, yl)
        report["dp_f32_loss"] = float(loss)
        if rank == 0:
            torch.save({k: v.cpu() for k, v in trainer.model.state_dict().items()},
                       os.path.join(folder, "dp_state.pt"))
        restore(old)
        del trainer, model
        # bf16 steps with AdamW on the same patches: the loss falls; times per step
        model = port.AnisotropicUNet(**TRACKED, device="cuda", seed=1)
        trainer = md_dp_trainer(port, model, x, y, os.path.join(folder, f"rank{rank}"), DataParallelTrainer,
                                mixed_precision=True, optimizer=port.OptimizerSpec("adamw", lr=LEARNING_RATE))
        trainer._initialize(MD_BF16_STEPS, None)
        trainer.model.train()
        losses = [float(trainer._train_step(xl, yl)[0]) for _ in range(MD_BF16_STEPS)]
        torch.cuda.reset_peak_memory_stats()
        report["dp_bf16_losses"] = losses
        report["dp_step_ms"], report["dp_step_device_ms"] = md_timed(lambda: trainer._train_step(xl, yl), 3)
        report["dp_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        grads = torch.cat([p.detach().reshape(-1).float() for p in trainer.model.parameters()])
        dist.barrier()
        report["allreduce_ms"], _ = md_timed(lambda: dist.all_reduce(grads), 5)
        report["gradient_mib"] = grads.numel() * 4 / 2 ** 20
        del trainer, model, grads
        torch.cuda.empty_cache()

        log(f"15b rank {rank}: data-parallel steps done")
        # halo_sharded_predict of the volume along z with the derived halo, bf16
        volume = np.load(os.path.join(folder, "halo_volume.npy"), mmap_mode="r")[None]
        mesh = get_mesh(axis_names=("space",))
        model = port.AnisotropicUNet(**TRACKED, dtype=torch.bfloat16, device="cuda", seed=0)
        halo = receptive_field_halo(model)
        report["halo"] = halo
        halo_sharded_predict(model, volume, mesh)  # cuDNN's first calls
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        launches = inorm.instance_norm.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        pred = halo_sharded_predict(model, volume, mesh)
        report["halo_seconds"] = time.perf_counter() - t
        report["halo_launches"] = inorm.instance_norm.launches - launches
        report["halo_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        z = MD_HALO_VOLUME[0] // world
        slab = torch.from_numpy(np.ascontiguousarray(volume[:, rank * z:(rank + 1) * z])).cuda()[None]
        dist.barrier()
        report["halo_exchange_ms"], _ = md_timed(lambda: _extend(slab, halo, 2, mesh.get_group("space")), 5)
        if rank == 0:
            np.save(os.path.join(folder, "halo_pred.npy"), pred)
        del model, pred, slab
        torch.cuda.empty_cache()

        log(f"15b rank {rank}: halo_sharded_predict done")
        # spatial_sharded_train_step on the patch, float32: gradients with the kernels and with the plain norms
        xs, ys = np.load(os.path.join(folder, "spatial_x.npy")), np.load(os.path.join(folder, "spatial_y.npy"))
        old = deterministic_f32()
        grads = {}
        for norm in ("kernel", "plain"):
            model = port.AnisotropicUNet(**TRACKED, dtype=torch.float32, device="cuda", seed=2)
            step, shard = spatial_sharded_train_step(model, port.DiceLoss(), port.OptimizerSpec("sgd", lr=1e-3),
                                                     mesh)
            xl, yl = shard(xs, ys)
            patch = (unittest.mock.patch.object(unet_module, "instance_norm", inorm.instance_norm_reference)
                     if norm == "plain" else contextlib.nullcontext())
            torch.cuda.reset_peak_memory_stats()
            with patch:
                report[f"spatial_{norm}_loss"] = float(step(xl, yl))
            report[f"spatial_{norm}_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            grads[norm] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
            if norm == "kernel":
                report["spatial_step_ms"], report["spatial_step_device_ms"] = md_timed(lambda: step(xl, yl), 1)
                sl = torch.from_numpy(xs).cuda()[:, :, :MD_SPATIAL_PATCH[0] // world]
                report["spatial_exchange_ms"], _ = md_timed(lambda: _extend(sl, halo, 2, mesh.get_group("space")), 5)
            del model, step
        restore(old)
        log(f"15b rank {rank}: spatial_sharded_train_step done")
        if rank == 0:
            torch.save(grads, os.path.join(folder, "spatial_grads.pt"))
        report["launches"] = [inorm.instance_norm.launches, inorm.instance_norm_backward.launches]
    finally:
        with open(os.path.join(folder, f"report-rank{rank}.json"), "w") as f:
            json.dump(report, f)
        dist.destroy_process_group()


def md_check_grads(kernel, plain):
    """The spatial step's gradients with the kernels against those with the plain norms."""
    largest = max(float(g.abs().max()) for g in plain.values())
    worst, total_diff, total = (0.0, None), 0.0, 0.0
    for name, ref in plain.items():
        got = kernel[name]
        diff, size = float((got - ref).double().norm()), float(ref.double().norm())
        total_diff, total = total_diff + diff ** 2, total + size ** 2
        tol = MD_GRAD_REL * size + GRAD_ATOL_OF_MODEL * largest * ref.numel() ** 0.5
        if not bool(torch.isfinite(got).all()) or diff > tol:
            raise AssertionError(f"spatial step: gradient of {name} with the kernels is {diff:.3g} (L2) from the "
                                 f"plain norms' (tolerance {tol:.3g})")
        worst = max(worst, (diff / max(size, 1e-30), name))
    rel_all = (total_diff / total) ** 0.5
    log(f"spatial step (float32, TF32 off): {len(plain)} gradients with the kernels against the plain norms: "
        f"all together {rel_all:.3g} of their norm (limit {MD_GRAD_REL_ALL}), worst tensor {worst[1]} "
        f"{worst[0]:.3g} (limit {MD_GRAD_REL} + {GRAD_ATOL_OF_MODEL}*max|grad| per element)")
    if rel_all > MD_GRAD_REL_ALL:
        raise AssertionError(f"spatial step: gradients with the kernels {rel_all:.3g} from the plain norms'")


def phase_multi_device(port, inorm, device_ops):
    """Phase 15: the multi-device paths on the one card; returns the norm kernels' launches of
    every process's runs (forward, backward)."""
    import torch.distributed as dist
    from torch.distributed.checkpoint.state_dict import get_state_dict

    from torch_em_tpu_torch.parallel import (DataParallelTrainer, init_process_group, restore_sharded_checkpoint,
                                             save_sharded_checkpoint, train_multi_gpu)
    from torch_em_tpu_torch.utils import validation

    t_phase = time.perf_counter()
    fwd = bwd = 0
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        raw, labels = training_volume(port)
        np.save(os.path.join(tmp, "raw.npy"), raw)
        np.save(os.path.join(tmp, "labels.npy"), labels)

        # 15a: train_multi_gpu in one process over NCCL, then from_checkpoint in a group of one
        report = os.path.join(tmp, "report-15a.json")
        t = time.perf_counter()
        train_multi_gpu(port.AnisotropicUNet, {**TRACKED, "seed": 0}, md_loader, dict(
                            folder=tmp, n_samples=MD_TRAIN_SAMPLES, shuffle=True),
                        md_loader, dict(folder=tmp, n_samples=MD_VAL_SAMPLES, shuffle=False), iterations=MD_FIT,
                        trainer_callable=ReportingTrainer(report), n_devices=1, name="md", save_root=tmp,
                        learning_rate=LEARNING_RATE, mixed_precision=True, logger=None,
                        device_label_transform=device_ops.DeviceAffinityTransform(offsets=OFFSETS))
        spawn_s = time.perf_counter() - t
        with open(report) as f:
            fitted = json.load(f)
        folder = os.path.join(tmp, "checkpoints", "md")
        validations = 1
        expected = (NORMS_PER_FORWARD * (MD_FIT + MD_VAL_SAMPLES * validations), (NORMS_PER_FORWARD - 1) * MD_FIT)
        log(f"15a train_multi_gpu, 1 process over NCCL: {MD_FIT} iterations in {fitted['seconds']:.2f} s fit "
            f"({spawn_s:.1f} s with the process's start), peak {fitted['peak_gib']:.2f} GiB, launches "
            f"{fitted['launches']} (expected {list(expected)}), validation metric {fitted['metric']:.4f}; "
            f"checkpoints {sorted(os.listdir(folder))}; {nvidia_smi()}")
        if fitted["iteration"] != MD_FIT or tuple(fitted["launches"]) != expected \
                or not np.isfinite(fitted["metric"]) or fitted["rank"] != 0:
            raise AssertionError(f"15a: {fitted}")
        fwd, bwd = fwd + fitted["launches"][0], bwd + fitted["launches"][1]

        init_process_group(f"file://{os.path.join(tmp, 'store-15a')}", 1, 0, device="cuda")
        try:
            if dist.get_backend() != MD_ONE_PROCESS_BACKEND:
                raise AssertionError(f"15a: backend {dist.get_backend()}")
            resumed = port.DefaultTrainer.from_checkpoint(folder, "latest")
            if not isinstance(resumed, DataParallelTrainer) or resumed.iteration != MD_FIT:
                raise AssertionError(f"15a: from_checkpoint gave {type(resumed).__name__} at {resumed.iteration}")
            inorm.instance_norm.launches = inorm.instance_norm_backward.launches = 0
            resumed.fit(iterations=MD_RESUME)
            torch.cuda.synchronize()
            launches = (inorm.instance_norm.launches, inorm.instance_norm_backward.launches)
            expected = (NORMS_PER_FORWARD * (MD_RESUME + MD_VAL_SAMPLES), (NORMS_PER_FORWARD - 1) * MD_RESUME)
            log(f"15a from_checkpoint in a group of one over NCCL: {MD_RESUME} more iterations, now "
                f"{resumed.iteration}; launches {launches} (expected {expected})")
            if resumed.iteration != MD_FIT + MD_RESUME or launches != expected:
                raise AssertionError("15a: the resumed fit")
            fwd, bwd = fwd + launches[0], bwd + launches[1]
            model_state, optim_state = get_state_dict(resumed.model, resumed.torch_optimizer)
            tree = {"model": model_state, "optimizer": optim_state, "iteration": resumed.iteration}
            t = time.perf_counter()
            path = save_sharded_checkpoint(os.path.join(tmp, "sharded"), tree)
            back = restore_sharded_checkpoint(path, tree)
            ckpt_s = time.perf_counter() - t
            leaves = [(a, b) for a, b in zip(_tree_leaves(tree), _tree_leaves(back))]
            equal = all(torch.equal(a, b) and b.device == a.device if isinstance(a, torch.Tensor) else a == b
                        for a, b in leaves)
            log(f"15a sharded checkpoint of the trainer's state: {len(leaves)} leaves, "
                f"{sum(isinstance(a, torch.Tensor) for a, _ in leaves)} tensors written and restored onto the card "
                f"in {ckpt_s:.2f} s, bitwise equal: {equal}; files {sorted(os.listdir(path))}")
            if not equal:
                raise AssertionError("15a: the sharded checkpoint does not restore bitwise")
            del resumed, tree, back, model_state, optim_state
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()

        # 15b: the inputs, the one-process references, then two processes on the card over gloo
        # one patch per process: the volume's first and last corners
        crops = [tuple(slice(0, p) for p in TRAIN_PATCH), tuple(slice(v - p, v) for v, p in zip(raw.shape, TRAIN_PATCH))]
        x = np.stack([raw[c][None] for c in crops]).astype(np.float32)
        targets = device_ops.DeviceAffinityTransform(offsets=OFFSETS)(
            torch.from_numpy(np.stack([labels[c][None] for c in crops]).astype(np.float32)).cuda()).cpu().numpy()
        np.save(os.path.join(tmp, "dp_x.npy"), x)
        np.save(os.path.join(tmp, "dp_y.npy"), targets)
        volume = np.random.default_rng(0).random(MD_HALO_VOLUME, dtype=np.float32)
        np.save(os.path.join(tmp, "halo_volume.npy"), volume)
        from scipy import ndimage
        noise = ndimage.gaussian_filter(np.random.default_rng(3).normal(size=MD_SPATIAL_PATCH), 2.0)
        np.save(os.path.join(tmp, "spatial_x.npy"), (noise / noise.std()).astype(np.float32)[None, None])
        np.save(os.path.join(tmp, "spatial_y.npy"), (noise > 0).astype(np.float32)[None, None])

        old = deterministic_f32()
        model = port.AnisotropicUNet(**TRACKED, dtype=torch.float32, device="cuda", seed=1)
        one = md_dp_trainer(port, model, x, targets, os.path.join(tmp, "one"), port.DefaultTrainer)
        one._initialize(1, None)
        one.model.train()
        one_loss, _ = one._train_step(torch.from_numpy(x).cuda(), torch.from_numpy(targets).cuda())
        one_state = {k: v.cpu() for k, v in one.model.state_dict().items()}
        restore(old)
        del one, model
        torch.cuda.empty_cache()

        t = time.perf_counter()
        torch.multiprocessing.spawn(md_worker, args=(MD_PROCESSES, os.path.join(tmp, "store-15b"), tmp),
                                    nprocs=MD_PROCESSES, join=True)
        spawn_s = time.perf_counter() - t
        reports = []
        for rank in range(MD_PROCESSES):
            with open(os.path.join(tmp, f"report-rank{rank}.json")) as f:
                reports.append(json.load(f))
        r0 = reports[0]
        state = torch.load(os.path.join(tmp, "dp_state.pt"), weights_only=True)
        param_err = max(float((state[k].float() - v.float()).abs().max()) for k, v in one_state.items()
                        if not k.endswith("num_batches_tracked"))
        log(f"15b {MD_PROCESSES} processes on one card over gloo ({spawn_s:.1f} s with their start): one "
            f"data-parallel step (float32, TF32 off) loss {r0['dp_f32_loss']:.6f} against {float(one_loss):.6f} in "
            f"one process on both patches (rel {MD_LOSS_RTOL}); parameters max abs diff {param_err:.3g} "
            f"(atol {MD_PARAM_ATOL})")
        if abs(r0["dp_f32_loss"] - float(one_loss)) > MD_LOSS_RTOL * abs(float(one_loss)) or param_err > MD_PARAM_ATOL:
            raise AssertionError("15b: the data-parallel step differs from the one-process step")
        for r in reports:
            losses = r["dp_bf16_losses"]
            log(f"15b rank {r['rank']}: bf16 data-parallel steps {[round(v, 4) for v in losses]}; step "
                f"{r['dp_step_ms']:.2f} ms as called, {r['dp_step_device_ms']:.2f} ms between CUDA events, peak "
                f"{r['dp_peak_gib']:.2f} GiB; gloo all_reduce of the {r['gradient_mib']:.1f} MiB of gradients "
                f"{r['allreduce_ms']:.2f} ms; {nvidia_smi()}")
            if not np.all(np.isfinite(losses)) or not np.mean(losses[-2:]) < np.mean(losses[:2]):
                raise AssertionError(f"15b rank {r['rank']}: the bf16 loss is not finite or does not fall")
            if r["halo_launches"] != NORMS_PER_FORWARD:
                raise AssertionError(f"15b rank {r['rank']}: {r['halo_launches']} norm launches in the sharded forward")

        sharded = np.load(os.path.join(tmp, "halo_pred.npy"))
        model = port.AnisotropicUNet(**TRACKED, dtype=torch.bfloat16, device="cuda", seed=0)
        blocked = port.predict_with_halo(volume, model, block_shape=MD_HALO_BLOCK, halo=(r0["halo"], 0, 0),
                                         preprocess=None)
        seconds = max(r["halo_seconds"] for r in reports)
        log(f"15b halo_sharded_predict {MD_HALO_VOLUME} over {MD_PROCESSES} processes, derived halo {r0['halo']}: "
            f"{volume.size / seconds / 1e6:.2f} Mvox/s ({seconds:.3f} s), peak "
            f"{[round(r['halo_peak_gib'], 2) for r in reports]} GiB per rank, the halo exchange "
            f"{[round(r['halo_exchange_ms'], 2) for r in reports]} ms per rank; {nvidia_smi()}")
        if sharded.shape != blocked.shape or not np.isfinite(sharded).all():
            raise AssertionError(f"15b: sharded prediction {sharded.shape}")
        check_close(f"15b halo_sharded_predict against predict_with_halo in {MD_HALO_BLOCK} blocks", sharded, blocked)
        del model, sharded, blocked

        grads = torch.load(os.path.join(tmp, "spatial_grads.pt"), weights_only=True)
        log(f"15b spatial_sharded_train_step {MD_SPATIAL_PATCH} over {MD_PROCESSES} processes (float32): loss "
            f"{r0['spatial_kernel_loss']:.6f} with the kernels, {r0['spatial_plain_loss']:.6f} with the plain norms; "
            f"step {r0['spatial_step_ms']:.1f} ms as called, {r0['spatial_step_device_ms']:.1f} ms between CUDA "
            f"events; halo exchange {[round(r['spatial_exchange_ms'], 2) for r in reports]} ms per rank; peak "
            f"{[round(r['spatial_kernel_peak_gib'], 2) for r in reports]} GiB per rank; {nvidia_smi()}")
        md_check_grads(grads["kernel"], grads["plain"])
        for r in reports:
            fwd, bwd = fwd + r["launches"][0], bwd + r["launches"][1]
        log(f"15b launches per rank: {[r['launches'] for r in reports]}")

        # 15c: two replicas on the card, then validate_checkpoint with two ids
        model = port.AnisotropicUNet(**TRACKED, dtype=torch.bfloat16, device="cuda", seed=0)
        volume = np.random.default_rng(0).random(VOLUME_SHAPE, dtype=np.float32)
        outputs = {}
        for ids in ([0], [0, 1], [0, 1]):
            torch.cuda.synchronize()
            launches = inorm.instance_norm.launches
            t = time.perf_counter()
            outputs[len(ids)] = port.predict_with_halo(volume, model, gpu_ids=ids, block_shape=BLOCK_SHAPE,
                                                       halo=HALO, batch_size=1)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
            n = inorm.instance_norm.launches - launches
            fwd += n
            log(f"15c predict_with_halo gpu_ids={ids} {VOLUME_SHAPE}: {volume.size / seconds / 1e6:.2f} Mvox/s "
                f"({seconds:.3f} s), {n} norm launches; {nvidia_smi()}")
        check_close("15c predict_with_halo on two replicas against one", outputs[2], outputs[1])
        del model, outputs
        launches = inorm.instance_norm.launches
        one_id = validation.validate_checkpoint(folder, gpu_ids=[0], visualize=False, max_samples=1)
        two_ids = validation.validate_checkpoint(folder, gpu_ids=[0, 1], visualize=False, max_samples=1)
        fwd += inorm.instance_norm.launches - launches
        check_close("15c validate_checkpoint with two ids against one", two_ids[0], one_id[0])
        log(f"15c validate_checkpoint of 15a's checkpoint with gpu_ids [0, 1]: a prediction of "
            f"{two_ids[0].shape}")
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s; norm launches forward {fwd}, backward {bwd}; "
        f"{nvidia_smi()}")
    return fwd, bwd


def s2d_data(folder):
    """The Shallow2Deep recipe's images (``scripts/torch_s2d_forests.py:s2d_images``, seed 0: the
    images its forests were fitted on, and two more to test on) as ``.npy`` under ``folder``: the
    training images as one (S2D_TRAIN, 512, 512) volume with their labels, the test images and labels
    as arrays."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    from torch_s2d_forests import TRAIN_IMAGES, s2d_images

    raw, labels = s2d_images(S2D_SEED)
    paths = os.path.join(folder, "s2d_raw.npy"), os.path.join(folder, "s2d_labels.npy")
    np.save(paths[0], raw[:TRAIN_IMAGES])
    np.save(paths[1], labels[:TRAIN_IMAGES])
    return paths, raw[TRAIN_IMAGES:], labels[TRAIN_IMAGES:]


def soft_dice(pred, target, eps=1e-6):
    pred, target = np.asarray(pred, dtype=np.float64), np.asarray(target, dtype=np.float64)
    return float(2 * (pred * target).sum() / ((pred * pred).sum() + (target * target).sum() + eps))


def s2d_host_costs(prepare, forests, raw):
    """Per 256x256 patch, the host's ms in the default filter bank and in the forest's predict_proba
    (the median over S2D_HOST_PATCHES patches of the training images)."""
    filters = prepare._get_filters(2, None)
    rng = np.random.default_rng(1)
    bank_ms, forest_ms = [], []
    for k in range(S2D_HOST_PATCHES):
        i, y, x = rng.integers(0, len(raw)), *rng.integers(0, raw.shape[1] - S2D_PATCH[1], 2)
        patch = np.asarray(raw[i, y:y + S2D_PATCH[1], x:x + S2D_PATCH[2]], dtype=np.float32)
        t = time.perf_counter()
        features = prepare._apply_filters(patch, filters)
        bank_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        proba = forests[k % len(forests)].predict_proba(features)
        forest_ms.append((time.perf_counter() - t) * 1e3)
        if proba.shape != (patch.size, 2) or not (0 <= proba.min() and proba.max() <= 1):
            raise AssertionError(f"forest probabilities of shape {proba.shape} in [{proba.min()}, {proba.max()}]")
    nodes = [len(f.feature) for f in forests]
    log(f"Shallow2Deep host per {S2D_PATCH[1]}x{S2D_PATCH[2]} patch: filter bank ({features.shape[1]} features) "
        f"{np.median(bank_ms):.2f} ms, predict_proba ({forests[0].n_estimators} trees, {min(nodes)}-{max(nodes)} nodes "
        f"per forest) {np.median(forest_ms):.2f} ms (medians of {S2D_HOST_PATCHES}); {os.cpu_count()} host cores")
    return {"filter_bank_ms": float(np.median(bank_ms)), "predict_proba_ms": float(np.median(forest_ms))}


def s2d_pickles(paths, tmp):
    """16d, sklearn's pickles with no sklearn: the committed pickles of the fixtures read node for node against their
    .npz records, the port's pickle of one refitted fixture against the sha256 recorded on the CPU, 16b's pickles
    against their .npz, and the ms of reading and writing a pickle of 16b's size. Returns the stats."""
    import make_forest_fixtures

    from torch_em_tpu_torch.shallow2deep import load_forest, node_differences, save_forest_pickle

    stats = {}
    read = make_forest_fixtures.read_pickled_fixtures(os.path.join(tmp, "sklearn_pickles"))
    wrong = {name: differences for name, (differences, _) in read.items() if differences}
    if wrong or sorted(read) != sorted(make_forest_fixtures.PICKLED_CASES):
        raise AssertionError(f"16d the committed sklearn pickles read as {sorted(read)}, differing in {wrong}")
    stats["fixture_pickle_read_ms"] = {name: seconds * 1e3 for name, (_, seconds) in read.items()}
    with open(make_forest_fixtures.PICKLE_RECORD) as f:
        recorded = json.load(f)["sha256"]
    digest = make_forest_fixtures.port_pickle(os.path.join(tmp, "port_fixture.pkl"))
    if digest != recorded:
        raise AssertionError(f"16d the port's pickle of {make_forest_fixtures.PICKLED_CASE} has sha256 {digest}, "
                             f"the CPU's {recorded}")
    for path in paths:
        if node_differences(load_forest(path[:-len(".npz")] + ".pkl"), load_forest(path)):
            raise AssertionError(f"16d {os.path.basename(path)[:-4]}.pkl differs from its .npz")
    forest, reads, writes = load_forest(paths[0]), [], []
    for k in range(5):
        target = os.path.join(tmp, f"timed_{k}.pkl")
        t = time.perf_counter()
        save_forest_pickle(forest, target)
        writes.append(time.perf_counter() - t)
        t = time.perf_counter()
        load_forest(target)
        reads.append(time.perf_counter() - t)
    stats.update(pickle_write_ms=float(np.median(writes)) * 1e3, pickle_read_ms=float(np.median(reads)) * 1e3,
                 pickle_bytes=os.path.getsize(target), pickle_nodes=len(forest.feature))
    log(f"16d sklearn pickles with no sklearn: the {len(read)} committed sklearn pickles of the fixtures "
        f"({', '.join(sorted(read))}) equal to their .npz records node for node, read in "
        f"{min(stats['fixture_pickle_read_ms'].values()):.2f}-{max(stats['fixture_pickle_read_ms'].values()):.2f} ms; "
        f"the port's pickle of {make_forest_fixtures.PICKLED_CASE} has the CPU's sha256 {digest[:16]}...; 16b's "
        f"{len(paths)} pickles equal their .npz; a forest of 16b ({forest.n_estimators} trees, {len(forest.feature)} "
        f"nodes, {stats['pickle_bytes']} bytes) written in {stats['pickle_write_ms']:.2f} ms and read in "
        f"{stats['pickle_read_ms']:.2f} ms (medians of 5)")
    return stats


def s2d_forest_fits(prepare, raw_path, label_path, test_raw, tmp):
    """Phase 16's forest fits with no sklearn: (a) the fixtures of scripts/make_forest_fixtures.py node for node,
    (b) the committed forests' recipe, (d) sklearn's pickles, (c) the advanced path with worst_tiles. Returns (b)'s
    .npz paths and the stats."""
    from torch_em_tpu_torch.ops.native import load_forest_library
    from torch_em_tpu_torch.shallow2deep import ForegroundTransform, load_forest

    if sys.modules.get("sklearn") is not None:
        raise AssertionError("sklearn was imported before the forests were fitted")

    scripts = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts")
    sys.path.insert(0, scripts)
    import make_forest_fixtures
    import torch_s2d_forests

    stats = {}
    # 16a: every fixture refitted, its data made anew from its seed, after the native build
    t = time.perf_counter()
    load_forest_library()
    stats["forest_build_s"] = time.perf_counter() - t
    fits = {}
    for path in sorted(glob.glob(os.path.join(scripts, "records", "forest", "*.npz"))):
        differences, same_draw, seconds = make_forest_fixtures.refit_fixture(path, n_jobs=1)
        name = os.path.basename(path)[:-len(".npz")]
        fits[name] = seconds
        if differences or same_draw is False:
            raise AssertionError(f"16a fixture {name}: the port's forest differs from sklearn's in {differences}, "
                                 f"the global draw after the fit {'differs' if same_draw is False else 'agrees'}")
    if len(fits) != len(make_forest_fixtures.FOREST_CASES):
        raise AssertionError(f"16a found {len(fits)} forest fixtures")
    stats["fixture_fit_s"] = fits
    log(f"16a fit_forest on the {len(fits)} forest fixtures: every forest equal to sklearn 1.9's node for node "
        f"(thresholds bitwise, out-of-bag arrays bitwise); fit seconds " + ", ".join(f"{k} {v:.4f}"
                                                                                     for k, v in fits.items())
        + f"; forest.cpp built and loaded in {stats['forest_build_s']:.2f} s")

    # 16b: the committed forests' recipe, refitted here
    paths, digest, seconds = torch_s2d_forests.fit_forests(os.path.join(tmp, "rfs"), S2D_SEED)
    with open(torch_s2d_forests.RECIPE_RECORD) as f:
        same_features = digest == json.load(f)["features_sha256"]
    differences = torch_s2d_forests.check_against_committed(paths)
    equal = not any(differences.values())
    stats.update(recipe_fit_s=seconds, recipe_features_equal=same_features, recipe_forests_equal=equal)
    log(f"16b prepare_shallow2deep, the committed forests' recipe ({torch_s2d_forests.N_FORESTS} forests of "
        f"{torch_s2d_forests.N_ESTIMATORS} trees, one thread): {seconds:.3f} s; features sha256 "
        f"{'equal to' if same_features else 'unlike'} the one recorded on the CPU; forests equal to the committed "
        f"ones node for node: {equal} {json.dumps(differences)}")
    if same_features and not equal:
        raise AssertionError("16b the same features gave other trees than sklearn's")
    if not same_features:
        log("16b this machine's filter bank differs from the CPU's in some bit, so its forests may too; 16a's "
            "fixtures are the gate of the fit")
    stats.update(s2d_pickles(paths, tmp))

    # 16c: the advanced path, worst_tiles, the stage-2 sample counts checked
    strategy_inputs = {}

    def worst_tiles(features, labels, rf_id, forests, forests_per_stage, fraction, **kwargs):
        strategy_inputs[rf_id] = (len(features), len(forests[rf_id - forests_per_stage].train_labels))
        return prepare.worst_tiles(features, labels, rf_id, forests, forests_per_stage, fraction, **kwargs)

    np.random.seed(S2D_SEED)
    advanced = os.path.join(tmp, "advanced")
    t = time.perf_counter()
    prepare.prepare_shallow2deep_advanced(
        raw_path, None, label_path, None, patch_shape_min=torch_s2d_forests.PATCH_MIN,
        patch_shape_max=torch_s2d_forests.PATCH_MAX, n_forests=S2D_STAGES * S2D_PER_STAGE, n_threads=1,
        output_folder=advanced, ndim=2, forests_per_stage=S2D_PER_STAGE, sample_fraction_per_stage=S2D_FRACTION,
        sampling_strategy=worst_tiles, label_transform=ForegroundTransform(ndim=2),
        n_estimators=torch_s2d_forests.N_ESTIMATORS, random_state=S2D_SEED)
    stats["advanced_fit_s"] = time.perf_counter() - t
    forests = [load_forest(os.path.join(advanced, f"rf_{i:04d}.npz")) for i in range(S2D_STAGES * S2D_PER_STAGE)]
    # each tree's root weighs its bootstrap, as many draws as the forest's training samples
    counts = [f.weighted_n_node_samples[f.node_offsets[:-1]] for f in forests]
    for rf_id, (n_new, n_before) in strategy_inputs.items():
        expected = n_before + int(S2D_FRACTION * n_new)
        if not (counts[rf_id] == expected).all() or \
                not (counts[rf_id - S2D_PER_STAGE] == n_before).all():
            raise AssertionError(f"16c forest {rf_id} trained on {counts[rf_id]} samples, not {expected}")
    features = prepare._apply_filters(test_raw[0, :256, :256].astype(np.float32), prepare._get_filters(2, None))
    for i, forest in enumerate(forests):
        proba = forest.predict_proba(features)
        if not (0 <= proba.min() and proba.max() <= 1) or not np.allclose(proba.sum(axis=1), 1, rtol=0, atol=1e-12):
            raise AssertionError(f"16c forest {i} predicts outside [0, 1]")
    stats["advanced_samples"] = [int(c[0]) for c in counts]
    log(f"16c prepare_shallow2deep_advanced, worst_tiles, {S2D_STAGES} stages of {S2D_PER_STAGE} forests of "
        f"{torch_s2d_forests.N_ESTIMATORS} trees: {stats['advanced_fit_s']:.3f} s; training samples per forest "
        f"{stats['advanced_samples']} (stage 2: stage 1's plus {S2D_FRACTION} of a new patch's, as expected); every "
        f"forest's probabilities in [0, 1] on a 256x256 test patch")
    return paths, stats


def phase_shallow2deep(port, inorm):
    """The Shallow2Deep recipe on the card, with no sklearn: the forests fitted on the host (the fixtures, the
    committed forests' recipe and the advanced path), the enhancer trained on the recipe's forests' predictions,
    exported as a bioimage.io package, validated, imported back, traced to torchscript, and ``Shallow2DeepModel``
    on the test images; the medical formats' round trip. Returns the kernels' launches of its training run and of
    the model's predictions."""
    import importlib

    from torch_em_tpu_torch.shallow2deep import Shallow2DeepModel, get_shallow2deep_loader, load_forest
    from torch_em_tpu_torch.transforms.label import labels_to_binary
    from torch_em_tpu_torch.utils import bioimageio_spec, io, medical_io, modelzoo

    prepare = importlib.import_module("torch_em_tpu_torch.shallow2deep.prepare_shallow2deep")
    t_phase = time.perf_counter()
    stats = {}
    with tempfile.TemporaryDirectory() as tmp:
        (raw_path, label_path), test_raw, test_labels = s2d_data(tmp)
        npz_paths, fit_stats = s2d_forest_fits(prepare, raw_path, label_path, test_raw, tmp)
        stats.update(fit_stats)
        # the enhancer trains from the sklearn pickles the port wrote, as the JAX package's enhancers do
        rf_paths = [p[:-len(".npz")] + ".pkl" for p in npz_paths]
        forests = [load_forest(p) for p in rf_paths]
        default_config = prepare._serialize_feature_config(prepare._get_filters(2, None))
        if len(forests) != 4 or any(f.feature_config != default_config or f.n_features_in_ != 28 for f in forests):
            raise AssertionError(f"forests {rf_paths} do not carry the default filter bank")
        if sys.modules.get("sklearn") is not None:
            raise AssertionError("the forests were fitted or read through sklearn")
        log(f"Shallow2Deep data: {np.load(raw_path, mmap_mode='r').shape} training images, {test_raw.shape} test "
            f"images, foreground {float((test_labels > 0).mean()):.3f}; {len(forests)} forests fitted here")
        stats.update(s2d_host_costs(prepare, forests, np.load(raw_path, mmap_mode="r")))

        def loader(n_samples, shuffle, workers=LOADER_THREADS, mode="thread"):
            return get_shallow2deep_loader(
                raw_path, None, label_path, None, rf_paths=rf_paths, batch_size=S2D_BATCH, patch_shape=S2D_PATCH,
                ndim=2, rf_channels=(1,), label_transform=labels_to_binary, n_samples=n_samples, shuffle=shuffle,
                num_workers=workers, worker_mode=mode)

        np.random.seed(3)
        model = port.UNet2d(**S2D_MODEL, depth=S2D_DEPTH, device="cuda", seed=0)
        start = {k: v.detach().clone() for k, v in model.state_dict().items()}
        trainer = port.default_segmentation_trainer(
            "s2d", model, loader(S2D_BATCH * S2D_FIT, True), loader(S2D_BATCH, False), learning_rate=LEARNING_RATE,
            device="cuda", mixed_precision=True, logger=LossLog, save_root=tmp)
        resumed, launches = fit_and_resume(port, inorm, trainer, S2D_FIT, S2D_RESUME, 1, "Shallow2Deep enhancer")
        if type(resumed.train_loader.dataset).__name__ != "Shallow2DeepDataset" or \
                resumed.train_loader.dataset.rf_paths != rf_paths:
            raise AssertionError("from_checkpoint did not rebuild the Shallow2Deep loader")
        end = resumed.model.state_dict()
        moved = sum(int((end[k] != v).sum()) for k, v in start.items()) / sum(v.numel() for v in start.values())
        log(f"Shallow2Deep enhancer: {moved:.1%} of the weights moved from their start")
        if moved <= 0.5:
            raise AssertionError(f"only {moved:.1%} of the enhancer's weights moved")
        x = next(iter(loader(S2D_BATCH, False, workers=0)))[0]

        # export, validation and import
        package = os.path.join(tmp, "s2d_package")
        config = modelzoo.get_shallow2deep_config(rf_paths[0])
        t = time.perf_counter()
        if not modelzoo.export_bioimageio_model(resumed.checkpoint_folder, package, input_data=x[0, 0].cpu().numpy(),
                                                config=config, checkpoint_name="latest", name="s2d-enhancer"):
            raise AssertionError("the exported package did not validate")
        stats["export_s"] = time.perf_counter() - t
        t = time.perf_counter()
        errors, warnings_ = bioimageio_spec.validate_model_rdf(package)
        if not modelzoo._validate_model(package) or errors:
            raise AssertionError(f"validation of the package: {errors}")
        stats["validate_s"] = time.perf_counter() - t
        t = time.perf_counter()
        imported, _ = modelzoo.import_bioimageio_model(package)
        torch.cuda.synchronize()
        stats["import_s"] = time.perf_counter() - t
        test_input = torch.from_numpy(np.load(os.path.join(package, "test_input.npy"))).cuda()
        resumed.model.eval()
        with torch.inference_mode():
            resumed.model.dtype = imported.dtype = torch.bfloat16
            a, b = resumed.model(test_input), imported(test_input)
            resumed.model.dtype = imported.dtype = torch.float32
        if next(imported.parameters()).device != next(resumed.model.parameters()).device or not torch.equal(a, b):
            raise AssertionError("the imported package's bf16 forward differs from the trainer's model")
        rdf = bioimageio_spec.read_rdf(os.path.join(package, "rdf.yaml"))
        log(f"Shallow2Deep package: exported in {stats['export_s']:.2f} s, validated in {stats['validate_s']:.2f} s "
            f"(no errors, warnings {warnings_}), imported in {stats['import_s']:.2f} s; its bf16 forward on the card "
            f"equals the trainer's model bitwise; weights {sorted(rdf['weights'])}, config {rdf['config']}")

        # torchscript: traced on the CPU with the plain norm, loaded on the card
        modelzoo.add_weight_formats(package, ["torchscript"])
        traced = torch.jit.load(os.path.join(package, "weights_torchscript.pt"), map_location="cuda")
        tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.inference_mode():
                err = float((traced(test_input) - imported(test_input)).abs().max())
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        log(f"torchscript weights on the card against the state-dict model, float32 (TF32 off): max abs err {err:.3g}")
        if not err <= S2D_CPU_ATOL:
            raise AssertionError(f"torchscript diverges by {err}")
        del imported, traced, trainer, model

        # the loader and the bare step, after the export: these steps move the trainer's weights
        for mode in ("thread", "process"):
            feed = loader(S2D_BATCH * (S2D_LOADER_STEPS + 2), True, mode=mode)
            stats[f"loader_{mode}_patches_per_s"] = loader_rate(resumed, feed, steps=S2D_LOADER_STEPS)
            log(f"Shallow2Deep loader, {LOADER_THREADS} {mode} workers, feeding steps: "
                f"{stats[f'loader_{mode}_patches_per_s']:.2f} patches/s; {nvidia_smi()}")
            if mode == "process":
                feed.shutdown()
        x, y = bare_step(resumed, loader(S2D_BATCH, False, workers=0), "Shallow2Deep enhancer")
        stats["step_ms_as_called"] = time_ms(resumed._train_step, x, y, iters=10, repeats=1)
        breakdown = device_breakdown("Shallow2Deep enhancer training step (bf16 forward, backward, AdamW)",
                                     lambda: resumed._train_step(x, y))
        stats["step_device_ms"], stats["step_idle"] = breakdown["device_ms"], breakdown["idle"]
        del resumed, x, y
        check_cpu_against_card("Shallow2Deep enhancer", port.UNet2d, dict(S2D_MODEL, depth=S2D_DEPTH),
                               [torch.rand(2, 1, 64, 64, generator=torch.Generator().manual_seed(0))], atol=S2D_CPU_ATOL)

        # Shallow2DeepModel on the test images: the forest on the host, the enhancer on the card. The filter
        # config is the default bank (None), which fitted the forests: a forest's recorded config names the
        # structure tensor, which the string form computes at outer scale 2 sigma, the default bank at 0.5 sigma
        s2d = Shallow2DeepModel(package, (rf_paths[0], 2, None), device="cuda")
        images = test_raw[:, None]
        t = time.perf_counter()
        rf_pred = s2d.rf_prediction(images)
        t_rf = time.perf_counter()
        s2d.enhance(rf_pred)  # warm-up
        torch.cuda.synchronize()
        inorm.instance_norm.launches = inorm.instance_norm_backward.launches = 0
        t_enhance = time.perf_counter()
        enhanced = s2d(images)
        t_call = time.perf_counter()
        s2d.enhance(rf_pred)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        predict_launches = (inorm.instance_norm.launches, inorm.instance_norm_backward.launches)
        if predict_launches != (2 * NORMS_PER_FORWARD, 0):
            raise AssertionError(f"Shallow2DeepModel launched the norms {predict_launches}")
        if enhanced.shape != images.shape or not np.all(np.isfinite(enhanced)) or \
                not (0 <= enhanced.min() and enhanced.max() <= 1):
            raise AssertionError(f"Shallow2DeepModel gave {enhanced.shape} in [{enhanced.min()}, {enhanced.max()}]")
        stats["rf_ms_per_image"] = (t_rf - t) * 1e3 / len(images)
        stats["enhancer_ms_per_image"] = (t_end - t_call) * 1e3 / len(images)
        stats["model_ms_per_image"] = (t_call - t_enhance) * 1e3 / len(images)
        fg = (test_labels > 0).astype(np.float64)
        stats["dice_forest"] = soft_dice(rf_pred[:, 0], fg)
        stats["dice_enhancer"] = soft_dice(enhanced[:, 0], fg)
        log(f"Shallow2DeepModel on {len(images)} test images {images.shape[2:]}: {stats['model_ms_per_image']:.1f} ms "
            f"per image as called, of it the forest (host) {stats['rf_ms_per_image']:.1f} ms and the enhancer (card, "
            f"float32) {stats['enhancer_ms_per_image']:.1f} ms; soft Dice against the labels: forest {stats['dice_forest']:.4f}, enhancer "
            f"{stats['dice_enhancer']:.4f}; norm launches {predict_launches}; {nvidia_smi()}")
        del s2d

        # the medical formats: a seeded volume as NIfTI and MetaImage, read back through load_data
        volume = np.random.default_rng(5).random(S2D_MEDICAL).astype(np.float32)
        labels = (volume > 0.5).astype(np.uint8)
        for name, save in (("volume.nii.gz", medical_io.save_nifti), ("volume.mha", medical_io.save_mha)):
            save(os.path.join(tmp, name), volume)
            if not np.array_equal(np.asarray(io.load_data(os.path.join(tmp, name))), volume):
                raise AssertionError(f"{name} did not read back bitwise")
        medical_io.save_nifti(os.path.join(tmp, "labels.nii.gz"), labels)
        ds = port.SegmentationDataset(os.path.join(tmp, "volume.nii.gz"), None, os.path.join(tmp, "labels.nii.gz"),
                                      None, patch_shape=(8, 32, 32))
        np.random.seed(0)
        patch, patch_labels = ds[0]
        if patch.shape != (1, 8, 32, 32) or not np.array_equal(patch_labels, (patch > 0.5).astype(np.float32)):
            raise AssertionError("a SegmentationDataset patch of the NIfTI volume does not match its labels")
        log(f"medical formats: {S2D_MEDICAL} float32 as .nii.gz and .mha read back bitwise through load_data; a "
            f"SegmentationDataset patch {patch.shape} of the .nii.gz")
    if sys.modules.get("sklearn") is not None:
        raise AssertionError("phase 16 imported sklearn")
    stats["norm_launches"] = [launches[0] + predict_launches[0], launches[1]]
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"Shallow2Deep: {json.dumps(stats)}; {nvidia_smi()}")
    torch.cuda.empty_cache()
    return launches[0] + predict_launches[0], launches[1]


def identity_transform(raw, labels):
    return raw, labels


def em_benchmark_volume(folder, shape, seed=0):
    """MitoLab benchmark EM_BENCHMARK_ID's layout at ``shape``: ``<folder>/10982/data/mito_benchmarks/lucchi_pp/
    lucchi_pp_{em,mito}.tif``, multi-page TIFFs written with PIL. Their content tiles a seeded EM_BLOCK: three z-slabs of
    ``utils/test.py:make_mito_image`` planes (mitochondria as short tubes in z), raw uint8, uint16 instance labels
    unique over the volume. Returns the folder of the TIFFs, the raw and the labels."""
    from PIL import Image

    from torch_em_tpu_torch.utils.test import make_mito_image

    rng = np.random.default_rng(seed)
    raw_block, label_block = np.empty(EM_BLOCK, np.uint8), np.zeros(EM_BLOCK, np.uint16)
    edges = np.linspace(0, EM_BLOCK[0], 4).astype(int)
    for z0, z1 in zip(edges[:-1], edges[1:]):
        plane, plane_labels = make_mito_image(rng, EM_BLOCK[1])
        raw_block[z0:z1] = np.round(plane[:, :EM_BLOCK[2]] * 255).astype(np.uint8)
        plane_labels = plane_labels[:, :EM_BLOCK[2]].astype(np.uint16)
        label_block[z0:z1] = np.where(plane_labels > 0, plane_labels + label_block.max(), 0)
    reps = tuple(s // b for s, b in zip(shape, EM_BLOCK))
    assert tuple(r * b for r, b in zip(reps, EM_BLOCK)) == tuple(shape), (shape, EM_BLOCK)
    raw, labels = np.tile(raw_block, reps), np.empty(shape, np.uint16)
    step = int(label_block.max())
    for k, (iz, iy, ix) in enumerate(np.ndindex(*reps)):
        tile = tuple(slice(i * b, (i + 1) * b) for i, b in zip((iz, iy, ix), EM_BLOCK))
        labels[tile] = np.where(label_block > 0, label_block + k * step, 0)
    out = os.path.join(folder, "10982", "data", "mito_benchmarks", "lucchi_pp")
    os.makedirs(out)
    for name, volume in (("lucchi_pp_em.tif", raw), ("lucchi_pp_mito.tif", labels)):
        planes = [Image.fromarray(p) for p in volume]
        planes[0].save(os.path.join(out, name), save_all=True, append_images=planes[1:])
    return out, raw, labels


def em_mitolab_images(folder, seed=0):
    """CEM-MitoLab's layout: EM_MITO_IMAGES 224x224 image and mask TIFFs in EM_MITO_DATASETS datasets under
    ``<folder>/11037/cem_mitolab/<dataset>/{images,masks}/``; each pair is one of EM_MITO_BASE seeded
    ``make_mito_image`` pairs, rotated, flipped and rolled. Returns {image path: (raw, labels)}."""
    from PIL import Image

    from torch_em_tpu_torch.utils.test import make_mito_image

    rng = np.random.default_rng(seed)
    base = [make_mito_image(rng, EM_2D_PATCH[0]) for _ in range(EM_MITO_BASE)]
    arrays = {}
    for i in range(EM_MITO_IMAGES):
        raw, labels = base[i % EM_MITO_BASE]
        k, flip, shift = int(rng.integers(4)), bool(rng.integers(2)), tuple(int(v) for v in rng.integers(0, 224, 2))

        def view(a):
            a = np.roll(np.rot90(a, k), shift, axis=(0, 1))
            return np.ascontiguousarray(a[:, ::-1] if flip else a)

        pair = view(np.round(raw * 255).astype(np.uint8)), view(labels.astype(np.uint8))
        ds = os.path.join(folder, "11037", "cem_mitolab", f"dataset_{i % EM_MITO_DATASETS}")
        for sub, arr in zip(("images", "masks"), pair):
            os.makedirs(os.path.join(ds, sub), exist_ok=True)
            Image.fromarray(arr).save(os.path.join(ds, sub, f"patch_{i:03d}.tiff"))
        arrays[os.path.join(ds, "images", f"patch_{i:03d}.tiff")] = pair
    return arrays


def check_zoo_samples(label, zoo, plain):
    """The first EM_CHECK_SAMPLES samples of the zoo's dataset and of ``plain``, a dataset over the same arrays in memory,
    under the same ``np.random.seed``: equal, element for element."""
    if len(zoo) != len(plain):
        raise AssertionError(f"{label}: the zoo's dataset has {len(zoo)} samples, the in-memory one {len(plain)}")
    for i in range(EM_CHECK_SAMPLES):
        np.random.seed(100 + i)
        got = zoo[i]
        np.random.seed(100 + i)
        expected = plain[i]
        for g, e in zip(got, expected):
            if g.shape != e.shape or g.dtype != e.dtype or not np.array_equal(g, e):
                raise AssertionError(f"{label}: sample {i} of the zoo's dataset differs from the in-memory dataset's")
    log(f"{label}: the first {EM_CHECK_SAMPLES} samples equal those of {type(plain).__name__} over the arrays in memory "
        f"(shapes {[tuple(a.shape) for a in got]}, {got[0].dtype}, {got[1].dtype})")


def phase_em_zoo(port, inorm):
    """The dataset zoo's EM readers on the card: 17a the CREMI recipe's tracked model through
    ``get_benchmark_loader`` over TIFF volumes at MitoLab benchmark 5's published shape, 17b UNet2d at
    DSB width through ``get_mitolab_loader`` (the numpy split, ``non_empty_images.json``); each trained with
    ``fit`` and resumed with ``from_checkpoint``, its loader timed with thread (and, 17a, process) workers
    beside the bare step, and its zoo dataset held against a dataset over the same arrays in memory.
    Returns the kernels' launches of the two training runs."""
    from torch_em_tpu_torch.data.datasets import (get_benchmark_dataset, get_benchmark_loader, get_mitolab_dataset,
                                                  get_mitolab_loader, get_mitolab_paths)
    from torch_em_tpu_torch.data.datasets.electron_microscopy import cem
    from torch_em_tpu_torch.transforms import get_raw_transform, labels_to_binary
    from torch_em_tpu_torch.utils import io

    t_phase = time.perf_counter()
    stats = {}
    launches = [0, 0]
    with tempfile.TemporaryDirectory() as tmp:
        # 17a: the 3-D volume at its published shape
        shape = cem.BENCHMARK_SHAPES[EM_BENCHMARK_ID]
        t = time.perf_counter()
        folder, raw, labels = em_benchmark_volume(tmp, shape)
        stats["volume_write_s"] = time.perf_counter() - t
        files = [os.path.join(folder, n) for n in ("lucchi_pp_em.tif", "lucchi_pp_mito.tif")]
        t = time.perf_counter()
        probed = [io.load_data(f) for f in files]
        stats["tiff_open_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        decoded = [io.load_image(f) for f in files]
        stats["tiff_decode_s"] = time.perf_counter() - t
        if [p.shape for p in probed] != [shape, shape] or not (np.array_equal(decoded[0], raw)
                                                               and np.array_equal(decoded[1], labels)):
            raise AssertionError(f"the TIFF volumes read back as {[p.shape for p in probed]}, not as written")
        del decoded, probed
        log(f"17a data: {shape} uint8 raw and uint16 labels ({int(labels.max())} mitochondria, foreground "
            f"{float((labels > 0).mean()):.3f}) as multi-page TIFFs ({sum(os.path.getsize(f) for f in files) / 2**20:.0f} "
            f"MiB) in {stats['volume_write_s']:.2f} s; opening both {stats['tiff_open_ms']:.1f} ms, decoding both "
            f"{stats['tiff_decode_s']:.2f} s ({2 * int(np.prod(shape)) / stats['tiff_decode_s'] / 1e6:.0f} Mvox/s)")

        def volume_loader(n_samples=None, shuffle=True, mode="thread", batch_size=1):
            return get_benchmark_loader(
                tmp, EM_BENCHMARK_ID, patch_shape=TRAIN_PATCH, batch_size=batch_size, label_transform=labels_to_binary,
                n_samples=n_samples, shuffle=shuffle, num_workers=LOADER_THREADS, worker_mode=mode)

        zoo = get_benchmark_dataset(tmp, EM_BENCHMARK_ID, patch_shape=TRAIN_PATCH, label_transform=labels_to_binary,
                                    transform=identity_transform)
        plain = port.SegmentationDataset(raw, None, labels, None, patch_shape=TRAIN_PATCH, raw_transform=get_raw_transform(),
                                         label_transform=labels_to_binary, transform=identity_transform)
        check_zoo_samples("17a get_benchmark_dataset", zoo, plain)
        del zoo, plain, raw, labels
        train = volume_loader()
        pipeline = train.dataset.transform
        log(f"17a loader: {type(train.dataset).__name__}, {len(train.dataset)} patches, transform "
            f"{getattr(pipeline, 'init_kwargs', pipeline)}, raw transform {type(train.dataset.raw_transform).__name__}")
        np.random.seed(4)
        model = port.AnisotropicUNet(**TRACKED, device="cuda", seed=0)
        trainer = port.default_segmentation_trainer(
            "em-benchmark", model, train, volume_loader(n_samples=1, shuffle=False), learning_rate=LEARNING_RATE,
            device="cuda", mixed_precision=True, logger=LossLog, save_root=tmp)
        t = time.perf_counter()
        resumed, fit_launches = fit_and_resume(port, inorm, trainer, EM_FIT, EM_RESUME, 1, "17a benchmark 5 3-D")
        stats["a_fit_s"] = time.perf_counter() - t
        launches = [launches[0] + fit_launches[0], launches[1] + fit_launches[1]]
        if resumed.train_loader.dataset.raw_path != files[0]:
            raise AssertionError("from_checkpoint did not rebuild the zoo's loader")
        # timed after two batches per worker: each worker process starts and decodes its own copy of the volume
        # first, and the first workers up serve several batches before the last one has
        for mode in ("thread", "process"):
            feed = volume_loader(2 * LOADER_THREADS + EM_LOADER_STEPS, mode=mode)
            stats[f"a_loader_{mode}_patches_per_s"] = loader_rate(resumed, feed, steps=EM_LOADER_STEPS,
                                                                  warmup=2 * LOADER_THREADS)
            log(f"17a loader, {LOADER_THREADS} {mode} workers, default augmentations, feeding steps: "
                f"{stats[f'a_loader_{mode}_patches_per_s']:.2f} patches/s; {nvidia_smi()}")
            if mode == "process":
                feed.shutdown()
        x, y = bare_step(resumed, volume_loader(1, shuffle=False, mode="thread"), "17a tracked AnisotropicUNet")
        stats["a_step_ms"] = time_ms(resumed._train_step, x, y, iters=10, repeats=1)
        del trainer, resumed, model, train, x, y
        torch.cuda.empty_cache()

        # 17b: 2-D patches through the numpy split and the non-empty cache
        t = time.perf_counter()
        arrays = em_mitolab_images(tmp)
        stats["b_images_write_s"] = time.perf_counter() - t

        def mitolab_loader(split, n_samples=None, shuffle=True):
            return get_mitolab_loader(
                tmp, split=split, batch_size=EM_2D_BATCH, patch_shape=EM_2D_PATCH, num_workers=LOADER_THREADS,
                label_transform=labels_to_binary, n_samples=n_samples, shuffle=shuffle)

        t = time.perf_counter()
        train = mitolab_loader("train")
        stats["b_paths_s"] = time.perf_counter() - t
        cache = os.path.join(tmp, "11037", "cem_mitolab", "non_empty_images.json")
        with open(cache) as f:
            kept = len(json.load(f)["images"])
        n_train = len(train.dataset)
        n_val = len(get_mitolab_paths(tmp, split="val")[0])
        if not os.path.exists(cache) or n_train + n_val != kept:
            raise AssertionError(f"MitoLab split {n_train} + {n_val} of {kept} non-empty images")
        log(f"17b data: {EM_MITO_IMAGES} 224x224 TIFF pairs in {stats['b_images_write_s']:.2f} s; {kept} non-empty, split "
            f"{n_train} train / {n_val} val in {stats['b_paths_s']:.2f} s (the non-empty cache written)")
        zoo = get_mitolab_dataset(tmp, "train", patch_shape=EM_2D_PATCH, label_transform=labels_to_binary,
                                  transform=identity_transform)
        pairs = [arrays[p] for p in zoo.raw_images]
        plain = port.data.TensorDataset([r for r, _ in pairs], [lab for _, lab in pairs], patch_shape=EM_2D_PATCH,
                                        raw_transform=get_raw_transform(), label_transform=labels_to_binary,
                                        transform=identity_transform)
        check_zoo_samples("17b get_mitolab_dataset", zoo, plain)
        del zoo, plain
        np.random.seed(5)
        model = port.UNet2d(**EM_2D_MODEL, depth=DSB_DEPTH, device="cuda", seed=0)
        trainer = port.default_segmentation_trainer(
            "em-mitolab", model, train, mitolab_loader("val", n_samples=EM_2D_BATCH, shuffle=False),
            learning_rate=LEARNING_RATE, device="cuda", mixed_precision=True, logger=LossLog, save_root=tmp)
        t = time.perf_counter()
        resumed, fit_launches = fit_and_resume(port, inorm, trainer, EM_FIT, EM_RESUME, 1, "17b MitoLab 2-D")
        stats["b_fit_s"] = time.perf_counter() - t
        launches = [launches[0] + fit_launches[0], launches[1] + fit_launches[1]]
        stats["b_loader_thread_patches_per_s"] = loader_rate(resumed, mitolab_loader("train"), steps=EM_LOADER_STEPS,
                                                             warmup=LOADER_THREADS)
        log(f"17b loader, {LOADER_THREADS} thread workers, default augmentations, feeding steps: "
            f"{stats['b_loader_thread_patches_per_s']:.2f} patches/s; {nvidia_smi()}")
        x, y = bare_step(resumed, mitolab_loader("train", shuffle=False), "17b UNet2d f=64")
        stats["b_step_ms"] = time_ms(resumed._train_step, x, y, iters=10, repeats=1)
        del trainer, resumed, model, train, x, y
    stats["norm_launches"] = launches
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"EM zoo: {json.dumps(stats)}; {nvidia_smi()}")
    torch.cuda.empty_cache()
    return tuple(launches)


def lm_dsb_layout(folder, seed=0):
    """The layout ``get_dsb_data`` leaves of StarDist's dsb2018 "reduced" source: ``<folder>/{train,test}/{images,masks}/
    <hex name>.tif``, LM_DSB_IMAGES seeded LM_DSB_SHAPE pairs. Raw is uint8 (bright disks of their own intensity,
    blurred, over smoothed noise), the masks uint16 instance labels (the disks, later ones over earlier ones).
    Returns {image path: (raw, labels)}."""
    from PIL import Image
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    h, w = LM_DSB_SHAPE
    yy, xx = np.mgrid[:h, :w]
    arrays = {}
    for split, n in zip(("train", "test"), LM_DSB_IMAGES):
        for sub in ("images", "masks"):
            os.makedirs(os.path.join(folder, split, sub))
        for _ in range(n):
            labels, raw = np.zeros(LM_DSB_SHAPE, np.uint16), np.zeros(LM_DSB_SHAPE, np.float32)
            for k in range(1, int(rng.integers(8, 25))):
                cy, cx, r = (int(v) for v in (rng.integers(0, h), rng.integers(0, w), rng.integers(5, 16)))
                box = np.s_[max(cy - r, 0):cy + r + 1, max(cx - r, 0):cx + r + 1]
                disk = (yy[box] - cy) ** 2 + (xx[box] - cx) ** 2 <= r ** 2
                labels[box][disk] = k
                raw[box][disk] = rng.uniform(0.4, 1.0)
            raw = ndimage.gaussian_filter(raw, 1.0) + 0.1 * ndimage.gaussian_filter(rng.normal(size=LM_DSB_SHAPE), 1.0)
            raw = np.clip(raw * 200 + 20, 0, 255).astype(np.uint8)
            name = f"{int(rng.integers(1 << 62)):016x}.tif"
            for sub, arr in (("images", raw), ("masks", labels)):
                Image.fromarray(arr).save(os.path.join(folder, split, sub, name))
            arrays[os.path.join(folder, split, "images", name)] = (raw, labels)
    return arrays


def lm_livecell_layout(folder, seed=0):
    """LIVECell's layout: LM_LIVECELL_IMAGES (train, val) seeded 704x520 uint8 TIFFs under
    ``<folder>/images/livecell_train_val_images/<cell type>/<cell type>_Phase_<well>_<n>_<time>_<id>.tif`` and
    ``<folder>/{train,val}.json`` in COCO form with LM_LIVECELL_CELLS cells per image as polygons: 16 integer vertices on
    an ellipse, the ellipses' circumscribed circles at least 2 px apart, so no two cells touch. Returns {split: [(file
    name, raw, cells)]}, ``cells`` the instance labels drawn with PIL as the reader rasterizes the polygons."""
    from PIL import Image, ImageDraw
    from scipy import ndimage

    from torch_em_tpu_torch.data.datasets.light_microscopy.livecell import CELL_TYPES

    rng = np.random.default_rng(seed)
    h, w = LM_LIVECELL_SHAPE
    t = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    image_dir = os.path.join(folder, "images", "livecell_train_val_images")
    out, image_id, ann_id = {}, 0, 0
    for split, n in zip(("train", "val"), LM_LIVECELL_IMAGES):
        coco = {"images": [], "annotations": [], "categories": [{"id": 1, "name": "cell"}]}
        out[split] = []
        for i in range(n):
            image_id += 1
            cell_type = CELL_TYPES[image_id % len(CELL_TYPES)]
            file_name = f"{cell_type}_Phase_{'ABCD'[i % 4]}{i % 12 + 1}_1_{i // 12:02d}d00h00m_{image_id}.tif"
            centres, radii = np.zeros((0, 2)), np.zeros(0)
            while len(radii) < LM_LIVECELL_CELLS:
                for c, r in zip(rng.uniform([14, 14], [h - 14, w - 14], (64, 2)), rng.uniform(6.5, 11, 64)):
                    if len(radii) < LM_LIVECELL_CELLS and (
                            not len(radii) or np.min(np.hypot(*(centres - c).T) - radii - r) >= 2):
                        centres, radii = np.vstack([centres, c]), np.append(radii, r)
            canvas = Image.new("I", (w, h), 0)
            draw = ImageDraw.Draw(canvas)
            polygons = []
            for k, ((cy, cx), a) in enumerate(zip(centres, radii), 1):
                b, theta = a * rng.uniform(0.6, 0.95), rng.uniform(0, np.pi)
                px = np.rint(cx + a * np.cos(t) * np.cos(theta) - b * np.sin(t) * np.sin(theta)).astype(int)
                py = np.rint(cy + a * np.cos(t) * np.sin(theta) + b * np.sin(t) * np.cos(theta)).astype(int)
                polygons.append([int(v) for xy in zip(px, py) for v in xy])
                draw.polygon(list(zip(px.tolist(), py.tolist())), fill=k, outline=k)
            cells = np.asarray(canvas).astype(np.uint16)
            areas = np.bincount(cells.ravel(), minlength=len(radii) + 1)[1:]
            if areas.min() < 50:
                raise AssertionError(f"LIVECell layout: a cell of {areas.min()} px, which the reader drops")
            coco["images"].append({"id": image_id, "file_name": file_name, "height": h, "width": w})
            for k, poly in enumerate(polygons, 1):
                ann_id += 1
                xs, ys = poly[0::2], poly[1::2]
                coco["annotations"].append({
                    "id": ann_id, "image_id": image_id, "category_id": 1, "iscrowd": 0, "segmentation": [poly],
                    "area": float(areas[k - 1]), "bbox": [min(xs), min(ys), max(xs) - min(xs), max(ys) - min(ys)]})
            inside = cells > 0
            halo = ndimage.binary_dilation(inside, iterations=2) & ~inside
            raw = ndimage.gaussian_filter(100 + 90 * inside - 40 * halo.astype(np.float32), 1.0)
            raw = raw + 6 * rng.normal(size=(h, w))
            raw = np.clip(raw, 0, 255).astype(np.uint8)
            os.makedirs(os.path.join(image_dir, cell_type), exist_ok=True)
            Image.fromarray(raw).save(os.path.join(image_dir, cell_type, file_name))
            out[split].append((file_name, raw, cells))
        with open(os.path.join(folder, f"{split}.json"), "w") as f:
            json.dump(coco, f)
    return out


def phase_lm_zoo(port, inorm):
    """The dataset zoo's light-microscopy readers on the card: 18a the DSB recipe through ``get_dsb_loader`` on
    dsb2018's layout at its published count (and a batch of the SPOCO recipe's loader), 18b the ViM-UNet / UNETR recipe's
    UNETR through ``get_livecell_loader`` on LIVECell's layout, its COCO polygons converted on first use; each trained
    with ``fit`` and resumed with ``from_checkpoint``, its thread loader timed beside the bare step, and its zoo dataset
    held against a dataset over the same arrays in memory. Returns the kernels' launches of the two training runs."""
    from torch_em_tpu_torch.data.datasets import (get_dsb_dataset, get_dsb_loader, get_livecell_dataset,
                                                  get_livecell_loader, get_livecell_paths)
    from torch_em_tpu_torch.transforms import BoundaryTransform, get_raw_transform
    from torch_em_tpu_torch.transforms.label import connected_components
    from torch_em_tpu_torch.utils import io

    t_phase = time.perf_counter()
    stats = {}
    launches = [0, 0]
    with tempfile.TemporaryDirectory() as tmp:
        # 18a: DSB at its published count
        dsb_root = os.path.join(tmp, "dsb")
        t = time.perf_counter()
        arrays = lm_dsb_layout(dsb_root)
        stats["a_write_s"] = time.perf_counter() - t
        log(f"18a data: {LM_DSB_IMAGES} train and test {LM_DSB_SHAPE} uint8 / uint16 TIFF pairs in "
            f"{stats['a_write_s']:.2f} s")

        def dsb_loader(split, shuffle, **kwargs):
            return get_dsb_loader(dsb_root, patch_shape=DSB_PATCH, batch_size=DSB_BATCH, split=split,
                                  num_workers=LOADER_THREADS, shuffle=shuffle, **kwargs)

        zoo = get_dsb_dataset(dsb_root, DSB_PATCH, split="train", boundaries=True, transform=identity_transform)
        pairs = [arrays[p] for p in zoo.raw_images]
        plain = port.data.TensorDataset([r for r, _ in pairs], [lab for _, lab in pairs], patch_shape=DSB_PATCH[1:],
                                        raw_transform=get_raw_transform(),
                                        label_transform=BoundaryTransform(add_binary_target=True),
                                        transform=identity_transform)
        check_zoo_samples("18a get_dsb_dataset", zoo, plain)
        del zoo, plain
        # the SPOCO recipe's loader (experiments/spoco/train_spoco_dsb.py): connected components as int32 labels
        spoco_kwargs = dict(label_transform=connected_components, label_dtype="int32")
        x, y = next(iter(dsb_loader("train", True, **spoco_kwargs)))
        if tuple(x.shape) != (DSB_BATCH,) + DSB_PATCH or tuple(y.shape) != (DSB_BATCH,) + DSB_PATCH \
                or y.dtype != torch.int32 or x.dtype != torch.float32:
            raise AssertionError(f"the SPOCO recipe's DSB batch is {tuple(x.shape)} {x.dtype}, "
                                 f"{tuple(y.shape)} {y.dtype}")
        x, y = next(iter(dsb_loader("train", False, transform=identity_transform, **spoco_kwargs)))
        ordered = get_dsb_dataset(dsb_root, DSB_PATCH, split="train").raw_images[:DSB_BATCH]
        for k, path in enumerate(ordered):
            expected = connected_components(arrays[path][1]).astype(np.int32)
            if not np.array_equal(y[k, 0].numpy(), expected):
                raise AssertionError(f"the SPOCO recipe's DSB labels of {os.path.basename(path)} are not the "
                                     f"components of its mask")
        log(f"18a SPOCO loader: batch {tuple(x.shape)} {x.dtype}, labels {tuple(y.shape)} {y.dtype}, the components of "
            f"the masks in memory (up to {int(y.max())} per image)")

        train, val = dsb_loader("train", True, boundaries=True), dsb_loader("test", False, boundaries=True)
        log(f"18a loaders: {len(train.dataset)} train and {len(val.dataset)} test images, {len(train)} and {len(val)} "
            f"batches, transform {getattr(train.dataset.transform, 'init_kwargs', train.dataset.transform)}")
        np.random.seed(6)
        model = port.UNet2d(**DSB_MODEL, depth=DSB_DEPTH, device="cuda", seed=0)
        trainer = port.default_segmentation_trainer(
            "lm-dsb", model, train, val, learning_rate=LEARNING_RATE, device="cuda", mixed_precision=True,
            logger=LossLog, save_root=tmp)
        t = time.perf_counter()
        resumed, fit_launches = fit_and_resume(port, inorm, trainer, LM_FIT, LM_RESUME, len(val), "18a DSB recipe")
        stats["a_fit_s"] = time.perf_counter() - t
        launches = [launches[0] + fit_launches[0], launches[1] + fit_launches[1]]
        if resumed.train_loader.dataset.raw_images != train.dataset.raw_images:
            raise AssertionError("from_checkpoint did not rebuild the DSB zoo loader")
        timed = DSB_BATCH * (LOADER_THREADS + LM_LOADER_STEPS)
        stats["a_loader_thread_patches_per_s"] = loader_rate(resumed, dsb_loader("train", True, boundaries=True,
                                                                                 n_samples=timed),
                                                             steps=LM_LOADER_STEPS, warmup=LOADER_THREADS)
        x, y = bare_step(resumed, dsb_loader("test", False, boundaries=True), "18a DSB UNet2d f=64")
        stats["a_step_ms"] = time_ms(resumed._train_step, x, y, iters=10, repeats=1)
        log(f"18a loader, {LOADER_THREADS} thread workers, default augmentations, feeding steps: "
            f"{stats['a_loader_thread_patches_per_s']:.2f} patches/s; the bare step {stats['a_step_ms']:.2f} ms, "
            f"{DSB_BATCH * 1e3 / stats['a_step_ms']:.2f} patches/s; {nvidia_smi()}")
        del trainer, resumed, model, train, val, x, y, arrays
        torch.cuda.empty_cache()

        # 18b: LIVECell's COCO annotations, converted on first use, into the recipe's UNETR
        lc_root = os.path.join(tmp, "livecell")
        t = time.perf_counter()
        images = lm_livecell_layout(lc_root)
        stats["b_write_s"] = time.perf_counter() - t
        n_cells = sum(len(np.unique(c)) - 1 for split in images.values() for _, _, c in split)
        n_images = sum(LM_LIVECELL_IMAGES)
        t = time.perf_counter()
        paths = {split: get_livecell_paths(lc_root, split) for split in images}
        stats["b_convert_s_per_image"] = (time.perf_counter() - t) / n_images
        log(f"18b data: {LM_LIVECELL_IMAGES} train and val 704x520 uint8 TIFFs, {n_cells} cells as COCO polygons, "
            f"written in {stats['b_write_s']:.2f} s; converted on first use in "
            f"{stats['b_convert_s_per_image']:.3f} s per image")
        for split, written in images.items():
            for (file_name, _, cells), seg_path in zip(written, paths[split][1]):
                got = io.load_image(seg_path).astype(np.int64)
                n_pairs = len(np.unique(cells.astype(np.int64) << 32 | got))
                if os.path.basename(seg_path) != file_name or not np.array_equal(got > 0, cells > 0) or \
                        not n_pairs == len(np.unique(cells)) == len(np.unique(got)):
                    raise AssertionError(f"18b: the converted labels of {file_name} are not the cells drawn")
        log(f"18b: the converted label TIFFs are the drawn cells, one to one ({n_cells} cells)")
        zoo = get_livecell_dataset(lc_root, "train", LM_LIVECELL_PATCH, boundaries=True, transform=identity_transform)
        plain = port.data.TensorDataset([r for _, r, _ in images["train"]], [c for _, _, c in images["train"]],
                                        patch_shape=LM_LIVECELL_PATCH, raw_transform=get_raw_transform(),
                                        label_transform=BoundaryTransform(add_binary_target=True),
                                        transform=identity_transform)
        check_zoo_samples("18b get_livecell_dataset", zoo, plain)
        del zoo, plain, images

        def livecell_loader(split, shuffle=False, **kwargs):
            return get_livecell_loader(lc_root, split, LM_LIVECELL_PATCH, batch_size=VIT_BATCH, boundaries=True,
                                       num_workers=LOADER_THREADS, shuffle=shuffle, **kwargs)

        train, val = livecell_loader("train", shuffle=True), livecell_loader("val")
        kwargs = dict(VIT_RECIPES[0][2])
        np.random.seed(12)
        torch.manual_seed(12)
        model = port.models.UNETR(**kwargs, device="cuda", seed=0)
        skip = model.use_skip_connection
        n_norms = len(unetr_norm_shapes(model.encoder.embed_dim, skip))
        trainer = port.default_segmentation_trainer(
            "lm-livecell", model, train, val, learning_rate=LEARNING_RATE, device="cuda", mixed_precision=True,
            logger=LossLog, save_root=tmp)
        t = time.perf_counter()
        resumed, fit_launches = fit_and_resume(port, inorm, trainer, LM_FIT, LM_RESUME, len(val), "18b UNETR recipe",
                                               norms=(n_norms, n_norms - 1 if skip else n_norms))
        stats["b_fit_s"] = time.perf_counter() - t
        launches = [launches[0] + fit_launches[0], launches[1] + fit_launches[1]]
        if resumed.train_loader.dataset.raw_images != train.dataset.raw_images:
            raise AssertionError("from_checkpoint did not rebuild the LIVECell zoo loader")
        timed = VIT_BATCH * (LOADER_THREADS + LM_LOADER_STEPS)
        stats["b_loader_thread_patches_per_s"] = loader_rate(resumed, livecell_loader("train", True, n_samples=timed),
                                                             steps=LM_LOADER_STEPS, warmup=LOADER_THREADS)
        x, y = bare_step(resumed, livecell_loader("val"), "18b UNETR vit_b")
        stats["b_step_ms"] = time_ms(resumed._train_step, x, y, iters=10, repeats=1)
        log(f"18b loader, {LOADER_THREADS} thread workers, default augmentations, feeding steps: "
            f"{stats['b_loader_thread_patches_per_s']:.2f} patches/s; the bare step {stats['b_step_ms']:.2f} ms, "
            f"{VIT_BATCH * 1e3 / stats['b_step_ms']:.2f} patches/s; {nvidia_smi()}")
        del trainer, resumed, model, train, val, x, y
    stats["norm_launches"] = launches
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"LM zoo: {json.dumps(stats)}; {nvidia_smi()}")
    torch.cuda.empty_cache()
    return tuple(launches)


def hp_monuseg_layout(folder, seed=0):
    """MoNuSeg's extracted layout: HP_MONUSEG_IMAGES (train, test) seeded HP_MONUSEG_SHAPE RGB TIFFs, the training ones
    under ``MoNuSeg 2018 Training Data/Tissue Images/`` with their Aperio XML under ``Annotations/``, the test ones with
    theirs beside them under ``MoNuSegTestData/``. Each image has HP_MONUSEG_NUCLEI nuclei as polygons of 16 vertices
    (to a tenth of a pixel) on ellipses whose circumscribed circles lie at least 2 px apart and inside the image, so
    each polygon is its own instance; the H&E-like raw is purple nuclei on pink stroma, blurred, with light noise.
    Returns {split: [(name, raw, nuclei)]}, ``nuclei`` the polygons drawn with PIL in file order (ids 1, 2, ...)."""
    from PIL import Image, ImageDraw
    from scipy import ndimage

    from torch_em_tpu_torch.data.datasets.histopathology.monuseg import ORGAN_SPLITS

    rng = np.random.default_rng(seed)
    h, w = HP_MONUSEG_SHAPE
    t = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    train_names = [n for organ in ("breast", "kidney", "liver", "prostate") for n in ORGAN_SPLITS[organ][:2]]
    test_names = ["TCGA-2Z-A9J9-01A-01-TS1", "TCGA-44-2665-01B-06-BS6"]
    out = {}
    for split, names, n in zip(("train", "test"), (train_names, test_names), HP_MONUSEG_IMAGES):
        base = os.path.join(folder, "MoNuSeg 2018 Training Data" if split == "train" else "MoNuSegTestData")
        image_dir = os.path.join(base, "Tissue Images") if split == "train" else base
        xml_dir = os.path.join(base, "Annotations") if split == "train" else base
        os.makedirs(image_dir, exist_ok=True)
        os.makedirs(xml_dir, exist_ok=True)
        out[split] = []
        for name in names[:n]:
            centres, radii = np.zeros((0, 2)), np.zeros(0)
            while len(radii) < HP_MONUSEG_NUCLEI:
                for c, r in zip(rng.uniform([12, 12], [h - 12, w - 12], (256, 2)), rng.uniform(4.5, 9.0, 256)):
                    if len(radii) < HP_MONUSEG_NUCLEI and (
                            not len(radii) or np.min(np.hypot(*(centres - c).T) - radii - r) >= 2):
                        centres, radii = np.vstack([centres, c]), np.append(radii, r)
            canvas = Image.new("I", (w, h), 0)
            draw = ImageDraw.Draw(canvas)
            regions = []
            for k, ((cy, cx), a) in enumerate(zip(centres, radii), 1):
                b, theta = a * rng.uniform(0.6, 0.95), rng.uniform(0, np.pi)
                # the vertices as the XML gives them to the reader
                px = [float(f"{v:.1f}") for v in cx + a * np.cos(t) * np.cos(theta) - b * np.sin(t) * np.sin(theta)]
                py = [float(f"{v:.1f}") for v in cy + a * np.cos(t) * np.sin(theta) + b * np.sin(t) * np.cos(theta)]
                draw.polygon(list(zip(px, py)), fill=k, outline=k)
                vertices = "".join(f'<Vertex X="{x:.1f}" Y="{y:.1f}" Z="0" />' for x, y in zip(px, py))
                regions.append(f'<Region Id="{k}" Type="0"><Vertices>{vertices}</Vertices></Region>')
            nuclei = np.asarray(canvas).astype(np.int32)
            colour = np.where((nuclei > 0)[..., None], np.float32([112, 58, 158]), np.float32([232, 188, 214]))
            raw = ndimage.gaussian_filter(colour, (1.2, 1.2, 0)) + 6 * rng.normal(size=(h, w, 3))
            raw = np.clip(raw, 0, 255).astype(np.uint8)
            Image.fromarray(raw).save(os.path.join(image_dir, f"{name}.tif"))
            with open(os.path.join(xml_dir, f"{name}.xml"), "w") as f:
                f.write('<?xml version="1.0"?>\n<Annotations MicronsPerPixel="0.252000"><Annotation Id="1"><Regions>'
                        + "".join(regions) + "</Regions></Annotation></Annotations>\n")
            out[split].append((name, raw, nuclei))
    return out


def med_amos_volume(rng):
    """One seeded CT volume of MED_AMOS_SHAPE in (X, Y, Z) order, int16 Hounsfield-like values, and its uint8 labels
    0-15: a tile of MED_PATCH's shape holds 15 ellipsoid organs, one per class, each with a value of its own (-100 to
    250 HU) in soft tissue (40 HU), and the volume repeats the tile, so that every training patch holds every class
    (a class a batch lacks adds a constant to the Dice loss, which would swamp the fall of 8 steps); light noise: 1%
    of the voxels off by up to 20 HU."""
    tile = tuple(MED_PATCH)
    x, y, z = np.ogrid[:tile[0], :tile[1], :tile[2]]
    raw_tile = np.full(tile, 40, np.int16)
    labels_tile = np.zeros(tile, np.uint8)
    for k in range(1, MED_AMOS_CLASSES):
        while True:
            c = rng.uniform(0, 1, 3) * tile
            r = rng.uniform(0.08, 0.2, 3) * tile
            inside = ((x - c[0]) / r[0]) ** 2 + ((y - c[1]) / r[1]) ** 2 + ((z - c[2]) / r[2]) ** 2 <= 1
            if (inside & (labels_tile == 0)).sum() >= inside.sum() // 2 > 0:  # at least half of it still free
                break
        labels_tile[inside] = k
        raw_tile[inside] = int(rng.integers(-100, 251))
    reps = tuple(s // p for s, p in zip(MED_AMOS_SHAPE, tile))
    assert tuple(r * p for r, p in zip(reps, tile)) == tuple(MED_AMOS_SHAPE), (MED_AMOS_SHAPE, tile)
    raw, labels = np.tile(raw_tile, reps), np.tile(labels_tile, reps)
    noisy = rng.random(MED_AMOS_SHAPE) < 0.01
    raw[noisy] += rng.integers(-20, 21, int(noisy.sum())).astype(np.int16)
    return raw, labels


def med_amos_layout(folder, seed=0):
    """AMOS' layout: ``<folder>/amos22/{imagesTr,labelsTr,imagesVa,labelsVa}/amos_<id>.nii.gz`` with
    MED_AMOS_VOLUMES (train, val) CT volumes (ids under 500) written with ``medical_io.save_nifti``, several at once
    (gzip leaves the interpreter while it compresses). Returns {split: [(name, raw, labels)]}."""
    from torch_em_tpu_torch.utils.medical_io import save_nifti

    rng = np.random.default_rng(seed)
    out, writes, pid = {}, [], 0
    for split, n in zip(("Tr", "Va"), MED_AMOS_VOLUMES):
        for sub in ("images", "labels"):
            os.makedirs(os.path.join(folder, "amos22", f"{sub}{split}"), exist_ok=True)
        out[split] = []
        for _ in range(n):
            pid += 1
            name = f"amos_{pid:04d}.nii.gz"
            raw, labels = med_amos_volume(rng)
            writes += [(os.path.join(folder, "amos22", f"images{split}", name), raw),
                       (os.path.join(folder, "amos22", f"labels{split}", name), labels)]
            out[split].append((name, raw, labels))
    with ThreadPoolExecutor(max_workers=len(writes)) as pool:
        for done in [pool.submit(save_nifti, path, array) for path, array in writes]:
            done.result()
    return out


def phase_hp_med_zoo(port, inorm):
    """The dataset zoo's histopathology and medical readers on the card: 19a UNet2d at DSB width on H&E input through
    ``get_monuseg_loader`` on MoNuSeg's layout, its XML polygons rasterized on first use; 19b UNet3d on one-hot organ
    targets through ``get_amos_loader(modality="CT")`` on AMOS' NIfTI volumes; each trained with ``fit`` and resumed
    with ``from_checkpoint``, its thread loader timed beside the bare step, and its zoo dataset held against a dataset
    over the same arrays in memory. Returns the kernels' launches of the two training runs."""
    from torch_em_tpu_torch.data.datasets import (get_amos_dataset, get_amos_loader, get_amos_paths,
                                                  get_monuseg_dataset, get_monuseg_loader, get_monuseg_paths)
    from torch_em_tpu_torch.transforms import BoundaryTransform, get_raw_transform
    from torch_em_tpu_torch.transforms.label import OneHotTransform
    from torch_em_tpu_torch.utils import io, medical_io

    t_phase = time.perf_counter()
    stats = {}
    launches = [0, 0]
    with tempfile.TemporaryDirectory() as tmp:
        # 19a: MoNuSeg's polygons, rasterized on first use, into UNet2d at DSB width
        hp_root = os.path.join(tmp, "monuseg")
        t = time.perf_counter()
        images = hp_monuseg_layout(hp_root)
        stats["a_write_s"] = time.perf_counter() - t
        n_images = sum(HP_MONUSEG_IMAGES)
        t = time.perf_counter()
        paths = {split: get_monuseg_paths(hp_root, split) for split in images}
        stats["a_convert_s_per_image"] = (time.perf_counter() - t) / n_images
        log(f"19a data: {HP_MONUSEG_IMAGES} train and test {HP_MONUSEG_SHAPE} RGB TIFFs with {HP_MONUSEG_NUCLEI} XML "
            f"polygons each, written in {stats['a_write_s']:.2f} s; converted on first use in "
            f"{stats['a_convert_s_per_image']:.3f} s per image")
        by_name = {name: (raw, nuclei) for written in images.values() for name, raw, nuclei in written}
        converted = [pair for split in paths.values() for pair in zip(*split)]
        for image_path, label_path in converted:
            name = os.path.splitext(os.path.basename(image_path))[0]
            raw, nuclei = by_name[name]
            got = io.load_image(label_path).astype(np.int32)
            if os.path.basename(label_path) != f"{name}.png" or not np.array_equal(got, nuclei) or \
                    len(np.unique(got)) - 1 != HP_MONUSEG_NUCLEI or not np.array_equal(io.load_image(image_path), raw):
                raise AssertionError(f"19a: the converted image or labels of {name} are not the polygons drawn")
        if len(converted) != n_images:
            raise AssertionError(f"19a: {len(converted)} images converted of {n_images}")
        log(f"19a: the converted labels are the drawn polygons, one instance each ({HP_MONUSEG_NUCLEI} an image, "
            f"{n_images * HP_MONUSEG_NUCLEI} in all)")
        zoo = get_monuseg_dataset(hp_root, HP_PATCH, "train", boundaries=True, transform=identity_transform)
        pairs = [by_name[os.path.splitext(os.path.basename(p))[0]] for p in zoo.raw_images]
        plain = port.data.TensorDataset([r.transpose(2, 0, 1) for r, _ in pairs], [lab for _, lab in pairs],
                                        patch_shape=HP_PATCH, with_channels=True, raw_transform=get_raw_transform(),
                                        label_transform=BoundaryTransform(add_binary_target=True),
                                        transform=identity_transform)
        check_zoo_samples("19a get_monuseg_dataset", zoo, plain)
        del zoo, plain, pairs, by_name, images

        def monuseg_loader(split, shuffle, **kwargs):
            return get_monuseg_loader(hp_root, HP_PATCH, DSB_BATCH, split, boundaries=True,
                                      num_workers=LOADER_THREADS, shuffle=shuffle, **kwargs)

        train, val = monuseg_loader("train", True, n_samples=DSB_BATCH * LM_FIT), monuseg_loader("test", False)
        log(f"19a loaders: {len(train.dataset)} train patches of {HP_MONUSEG_IMAGES[0]} images and "
            f"{len(val.dataset)} test images, {len(train)} and {len(val)} batches, transform "
            f"{getattr(train.dataset.transform, 'init_kwargs', train.dataset.transform)}")
        np.random.seed(7)
        model = port.UNet2d(**HP_MODEL, depth=DSB_DEPTH, device="cuda", seed=0)
        trainer = port.default_segmentation_trainer(
            "hp-monuseg", model, train, val, learning_rate=LEARNING_RATE, device="cuda", mixed_precision=True,
            logger=LossLog, save_root=tmp)
        t = time.perf_counter()
        resumed, fit_launches = fit_and_resume(port, inorm, trainer, LM_FIT, LM_RESUME, len(val), "19a MoNuSeg UNet2d")
        stats["a_fit_s"] = time.perf_counter() - t
        launches = [launches[0] + fit_launches[0], launches[1] + fit_launches[1]]
        if resumed.train_loader.dataset.raw_images != train.dataset.raw_images:
            raise AssertionError("from_checkpoint did not rebuild the MoNuSeg zoo loader")
        timed = DSB_BATCH * (LOADER_THREADS + LM_LOADER_STEPS)
        stats["a_loader_thread_patches_per_s"] = loader_rate(resumed, monuseg_loader("train", True, n_samples=timed),
                                                             steps=LM_LOADER_STEPS, warmup=LOADER_THREADS)
        x, y = bare_step(resumed, monuseg_loader("train", False, n_samples=DSB_BATCH), "19a UNet2d f=64 H&E")
        stats["a_step_ms"] = time_ms(resumed._train_step, x, y, iters=10, repeats=1)
        log(f"19a loader, {LOADER_THREADS} thread workers, default augmentations, feeding steps: "
            f"{stats['a_loader_thread_patches_per_s']:.2f} patches/s; the bare step {stats['a_step_ms']:.2f} ms, "
            f"{DSB_BATCH * 1e3 / stats['a_step_ms']:.2f} patches/s; {nvidia_smi()}")
        del trainer, resumed, model, train, val, x, y
        torch.cuda.empty_cache()

        # 19b: AMOS' CT volumes as NIfTI into UNet3d on one-hot organ targets
        med_root = os.path.join(tmp, "amos")
        t = time.perf_counter()
        volumes = med_amos_layout(med_root)
        stats["b_write_s"] = time.perf_counter() - t
        decode = []
        for split, written in volumes.items():
            for name, raw, labels in written:
                for sub, array in (("images", raw), ("labels", labels)):
                    path = os.path.join(med_root, "amos22", f"{sub}{split}", name)
                    t = time.perf_counter()
                    got = medical_io.load_nifti(path)
                    decode.append(time.perf_counter() - t)
                    if got.shape != MED_AMOS_SHAPE or got.dtype != array.dtype or not np.array_equal(got, array):
                        raise AssertionError(f"19b: {sub}{split}/{name} reads back as {got.shape} {got.dtype}")
        stats["b_decode_s_per_volume"] = decode[0::2]
        stats["b_decode_s_per_label_volume"] = decode[1::2]
        sizes = [os.path.getsize(os.path.join(med_root, "amos22", f"images{s}", n)) for s, w in volumes.items()
                 for n, _, _ in w]
        log(f"19b data: {MED_AMOS_VOLUMES} train and val CT volumes {MED_AMOS_SHAPE} int16 (X, Y, Z) with uint8 labels "
            f"0-{MED_AMOS_CLASSES - 1} as .nii.gz ({np.mean(sizes) / 2 ** 20:.1f} MiB a volume) in "
            f"{stats['b_write_s']:.2f} s; gunzip and decode {np.mean(decode[0::2]):.3f} s a volume, "
            f"{np.mean(decode[1::2]):.3f} s a label volume")
        expected = [os.path.join(med_root, "amos22", "imagesTr", n) for n, _, _ in volumes["Tr"]]
        if get_amos_paths(med_root, "train", modality="CT")[0] != expected or \
                get_amos_paths(med_root, "train", modality="MRI")[0]:
            raise AssertionError("19b: get_amos_paths does not list the CT volumes alone")
        one_hot = OneHotTransform(MED_AMOS_CLASSES)
        zoo = get_amos_dataset(med_root, MED_PATCH, "train", modality="CT", label_transform=one_hot,
                               transform=identity_transform)
        plain = port.data.ConcatDataset(*[port.SegmentationDataset(
            raw, None, labels, None, patch_shape=MED_PATCH, raw_transform=get_raw_transform(),
            label_transform=one_hot, transform=identity_transform) for _, raw, labels in volumes["Tr"]])
        check_zoo_samples("19b get_amos_dataset", zoo, plain)
        label_patch = volumes["Tr"][0][2][tuple(slice(0, p) for p in MED_PATCH)]
        stats["b_one_hot_ms"] = time_host_ms(one_hot, label_patch)
        del zoo, plain, volumes, label_patch

        def amos_loader(split, shuffle, n_samples):
            return get_amos_loader(med_root, MED_PATCH, MED_BATCH, split, modality="CT", label_transform=one_hot,
                                   num_workers=LOADER_THREADS, shuffle=shuffle, n_samples=n_samples)

        t = time.perf_counter()
        train = amos_loader("train", True, MED_BATCH * LM_FIT)
        stats["b_train_loader_build_s"] = time.perf_counter() - t
        val = amos_loader("val", False, MED_BATCH)
        log(f"19b loaders: {len(train.dataset)} train and {len(val.dataset)} val patches, {len(train)} and {len(val)} "
            f"batches, built in {stats['b_train_loader_build_s']:.2f} s (the train volumes decoded), transform "
            f"{getattr(train.dataset.datasets[0].transform, 'init_kwargs', None)}; one-hot of a {MED_PATCH} label "
            f"patch {stats['b_one_hot_ms']:.1f} ms on the host")
        np.random.seed(8)
        model = port.UNet3d(**MED_MODEL, depth=MED_DEPTH, device="cuda", seed=0)
        trainer = port.default_segmentation_trainer(
            "med-amos", model, train, val, learning_rate=LEARNING_RATE, device="cuda", mixed_precision=True,
            logger=LossLog, save_root=tmp)
        t = time.perf_counter()
        resumed, fit_launches = fit_and_resume(port, inorm, trainer, LM_FIT, LM_RESUME, len(val), "19b AMOS UNet3d")
        stats["b_fit_s"] = time.perf_counter() - t
        launches = [launches[0] + fit_launches[0], launches[1] + fit_launches[1]]
        if [d.raw_path for d in resumed.train_loader.dataset.datasets] != [d.raw_path for d in train.dataset.datasets]:
            raise AssertionError("from_checkpoint did not rebuild the AMOS zoo loader")
        timed = MED_BATCH * (LOADER_THREADS + LM_LOADER_STEPS)
        stats["b_loader_thread_patches_per_s"] = loader_rate(resumed, amos_loader("train", True, timed),
                                                             steps=LM_LOADER_STEPS, warmup=LOADER_THREADS)
        x, y = bare_step(resumed, amos_loader("train", False, MED_BATCH), "19b UNet3d f=32 CT")
        stats["b_step_ms"] = time_ms(resumed._train_step, x, y, iters=10, repeats=1)
        log(f"19b loader, {LOADER_THREADS} thread workers, default augmentations, one-hot targets, feeding steps: "
            f"{stats['b_loader_thread_patches_per_s']:.2f} patches/s; the bare step {stats['b_step_ms']:.2f} ms, "
            f"{MED_BATCH * 1e3 / stats['b_step_ms']:.2f} patches/s; {nvidia_smi()}")
        del trainer, resumed, model, train, val, x, y
    stats["norm_launches"] = launches
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"HP and medical zoo: {json.dumps(stats)}; {nvidia_smi()}")
    torch.cuda.empty_cache()
    return tuple(launches)


def phase_quality_probes(port, inorm):
    """The quality probes' paths at a smoke run's length, through the scripts' own functions: the DSB probe, the
    tracked DSB and the tracked CREMI run, each trained QP_FIT iterations and scored by its evaluator on its best
    checkpoint, then the SPOCO and SNEMI probes the same way, all under the scripts' deterministic settings. Checks the
    launches (training steps, validations, the scores' forwards), a finite and falling loss and finite scores
    (Dice and F1 in [0, 1]). Returns the kernels' launches of the five runs."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    import torch_parity2d
    import torch_parity3d
    import torch_spoco2d

    probe = torch_parity2d.SCALES["probe"]
    if (probe["features"], probe["batch_size"], (probe["size"],) * 2) != (DSB_PROBE_FEATURES, DSB_PROBE_BATCH,
                                                                           DSB_PROBE_PATCH) or \
            torch_parity2d.EVAL_BATCH != QP_EVAL_BATCH:
        raise AssertionError(f"the DSB probe's model, batch or evaluation batch left phases 3 and 5's rows: {probe}")
    if (torch_spoco2d.SIZE, torch_spoco2d.BATCH) != (DSB_PROBE_PATCH[0], DSB_PROBE_BATCH) or \
            (torch_parity3d.SCALE_FACTORS, torch_parity3d.PATCH) != (SNEMI_PROBE_SCALES, SNEMI_PROBE_PATCH):
        raise AssertionError("the SPOCO or SNEMI probe's batch or patch left phases 3 and 5's rows")
    t_phase = time.perf_counter()
    stats = {}
    launches = [0, 0]
    with tempfile.TemporaryDirectory() as tmp:
        def dsb_score_forwards(paths):  # the val images in batches of QP_EVAL_BATCH
            return -(-len(paths["val"][0]) // QP_EVAL_BATCH)

        def unit_scores(run):
            return {k: v for k, v in run.items() if k.startswith("dice_")}

        def instance_scores(run):
            return {k: run[k] for k in ("mean_voi", "mean_one_minus_rand_index", "mean_adapted_rand_error",
                                        "mean_f1") if k in run}

        dsb = {}

        def dsb_probe_data():
            dsb["paths"] = torch_parity2d.make_data(os.path.join(tmp, "dsb_probe"), "probe")
            return dsb["paths"]

        settled = torch_parity3d.deterministic  # the scripts' --deterministic
        # (label, scores, checked score, iterations, norms a forward, forwards a step and a validation batch,
        # settings, scoring forwards, data, training)
        cases = (
            ("20a DSB probe", unit_scores, "dice_mean", QP_FIT, NORMS_PER_FORWARD, 1, settled, dsb_score_forwards,
             dsb_probe_data, lambda paths: torch_parity2d.train_seed(paths, "probe", 0, QP_FIT, "cuda", tmp)),
            ("20b DSB tracked", unit_scores, "dice_mean", QP_FIT, NORMS_PER_FORWARD, 1, settled, dsb_score_forwards,
             lambda: torch_parity2d.make_data(os.path.join(tmp, "dsb_tracked"), "tracked", *QP_DSB_IMAGES),
             lambda paths: torch_parity2d.train_seed(paths, "tracked", 0, QP_FIT, "cuda", tmp)),
            ("20c CREMI tracked", unit_scores, "dice_boundary", QP_FIT, NORMS_PER_FORWARD, 1, settled,
             lambda paths: len(paths["val"]),  # one crop a val volume
             lambda: torch_parity3d.make_data(os.path.join(tmp, "cremi_tracked"), "tracked", *QP_CREMI_VOLUMES),
             lambda paths: torch_parity3d.train_boundary(paths, 0, QP_FIT, "cuda", tmp, "tracked")),
            # the model and its moving average a step and a validation batch; one forward per tune and test image
            ("20d SPOCO probe", instance_scores, "mean_voi", QP_FIT, NORMS_PER_FORWARD, 2, settled,
             lambda paths: len(paths["val"][0]), lambda: dsb["paths"],
             lambda paths: torch_spoco2d.train_seed(paths, 0, QP_FIT, "cuda", tmp)),
            ("20e SNEMI probe", instance_scores, "mean_f1", QP_SNEMI_FIT, SNEMI_PROBE_NORMS, 1,
             settled, lambda paths: len(paths["val"]),  # one crop a val volume
             lambda: torch_parity3d.make_data(os.path.join(tmp, "snemi_probe"), "probe"),
             lambda paths: torch_parity3d.train_affinity(paths, 0, QP_SNEMI_FIT, "cuda", tmp)))
        for label, scores_of, score, fit, norms, forwards, settings, score_forwards_of, make_data, train in cases:
            t = time.perf_counter()
            paths = make_data()
            data_s = time.perf_counter() - t
            np.random.seed(0)
            torch.manual_seed(0)
            torch.cuda.synchronize()
            with settings():
                flags = torch_parity3d.backend_flags()
                inorm.instance_norm.launches = inorm.instance_norm_backward.launches = 0
                t = time.perf_counter()
                run, trainer = train(paths)
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t
                got = (inorm.instance_norm.launches, inorm.instance_norm_backward.launches)
            validations, score_forwards = len(trainer.logger.metrics), score_forwards_of(paths)
            expected = (norms * (forwards * (fit + len(trainer.val_loader) * validations) + score_forwards),
                        (norms - 1) * fit)
            log(f"{label}: data {data_s:.2f} s; fit, best checkpoint and score {run_s:.2f} s; launches forward "
                f"{got[0]}, backward {got[1]} for {fit} steps, {validations} validations of "
                f"{len(trainer.val_loader)} batch(es) and {score_forwards} scoring forward(s) (expected {expected}); "
                f"flags {json.dumps(flags)}")
            if got != expected:
                raise AssertionError(f"{label}: kernel launches {got}, expected {expected}")
            launches = [launches[0] + got[0], launches[1] + got[1]]
            losses = trainer.logger.losses
            window = max(4, fit // 5)
            first, last = float(np.mean(losses[:window])), float(np.mean(losses[-window:]))
            scores = scores_of(run)
            log(f"{label}: loss first {window} {first:.4f}, last {window} {last:.4f}; best checkpoint at iteration "
                f"{run['best_checkpoint_iteration']}; {json.dumps(scores)}")
            if len(losses) != fit or not np.all(np.isfinite(losses)) or not last < first:
                raise AssertionError(f"{label}: the training loss is not finite or does not fall")
            bounded = [v for k, v in scores.items() if k.startswith("dice_") or k == "mean_f1"]
            if score not in scores or not all(np.isfinite(v) and v >= 0 for v in scores.values()) or \
                    not all(v <= 1 for v in bounded):
                raise AssertionError(f"{label}: scores {scores}")
            stats[label.split()[0]] = {"data_s": data_s, "run_s": run_s, score: run[score], "loss": [first, last]}
            del trainer
            torch.cuda.empty_cache()
    stats["norm_launches"] = launches
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"quality probes: {json.dumps(stats)}; {nvidia_smi()}")
    return tuple(launches)


# phase 21: the partials at the tracked widths (the tracked model's second level and its upsampler into the first,
# anisotropic; the DSB model's second level in 2-D and its upsampler), bf16 on the card: (partial, its dim form's
# arguments, input shape)
NAMES_CASES = (
    ("ConvBlock3d", dict(in_channels=32, out_channels=64, kernel_size=(1, 3, 3), padding=(0, 1, 1)),
     (1, 32, 32, 128, 128)),
    ("ConvBlock2d", dict(in_channels=64, out_channels=128), (DSB_BATCH, 64, 128, 128)),
    ("Upsampler3d", dict(in_channels=64, out_channels=32, scale_factor=(1, 2, 2)), (1, 64, 32, 64, 64)),
    ("Upsampler3d", dict(in_channels=64, out_channels=32, scale_factor=(1, 2, 2), mode="nearest"),
     (1, 64, 32, 64, 64)),
    ("Upsampler2d", dict(in_channels=128, out_channels=64, scale_factor=2), (DSB_BATCH, 128, 64, 64)),
    ("Upsampler2d", dict(in_channels=128, out_channels=64, scale_factor=2, mode="nearest"), (DSB_BATCH, 128, 64, 64)),
)


def phase_public_names(unet_module, inorm):
    """Each public partial on the card against its ``dim`` form, bitwise, on the same weights and bf16 input with
    deterministic cuDNN; the native library's ``is_available()``. The norm launches of these forwards are logged
    and left out of the kernels line: they compare two forms of one path."""
    from torch_em_tpu_torch.ops import native

    t = time.perf_counter()
    old = deterministic_f32()
    inorm.instance_norm.launches = 0
    try:
        for i, (name, kwargs, shape) in enumerate(NAMES_CASES):
            dim = 3 if name.endswith("3d") else 2
            full_cls = unet_module.ConvBlock if name.startswith("ConvBlock") else unet_module.Upsampler
            full_form = full_cls(**kwargs, dim=dim)
            for m in full_form.modules():
                if isinstance(m, unet_module._Conv):
                    m.reset_parameters(torch.Generator().manual_seed(i))
            partial_form = getattr(unet_module, name)(**kwargs)
            partial_form.load_state_dict(full_form.state_dict(), strict=True)
            full_form, partial_form = full_form.cuda(), partial_form.cuda()
            x = torch.randn(shape, generator=card_generator(i), device="cuda").to(torch.bfloat16)
            with torch.inference_mode():
                got, expected = partial_form(x), full_form(x)
            equal = torch.equal(got, expected)
            log(f"21 {name}({', '.join(f'{k}={v}' for k, v in kwargs.items())}) on {tuple(shape)} bf16: output "
                f"{tuple(got.shape)}, equal to {full_cls.__name__}(dim={dim}) bitwise: {equal}")
            if not equal or tuple(got.shape[:2]) != (shape[0], kwargs["out_channels"]) or \
                    not bool(torch.isfinite(got).all()):
                raise AssertionError(f"21 {name} differs from its dim form or is not finite")
        available = native.is_available()
        expected_launches = 2 * 2 * sum(name.startswith("ConvBlock") for name, _, _ in NAMES_CASES)
        log(f"21 ops.native.is_available(): {available}; norm launches of the comparisons "
            f"{inorm.instance_norm.launches} (expected {expected_launches}: 2 a ConvBlock forward, both forms); "
            f"{time.perf_counter() - t:.2f} s")
        if available is not True or inorm.instance_norm.launches != expected_launches:
            raise AssertionError("21 the native library is not available or the blocks' norms did not launch")
    finally:
        restore(old)
    # the classification scores in numpy against sklearn's recorded values
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    import make_forest_fixtures

    t = time.perf_counter()
    errors = make_forest_fixtures.score_errors()
    worst = max(errors, key=lambda e: e[-1])
    names = sorted({name for name, *_ in errors})
    log(f"21 ClassificationMetric's numpy scores on the recorded label vectors: {len(errors)} cases of {len(names)} "
        f"scores ({', '.join(names)}) against sklearn's recorded values: max abs err {worst[-1]:.3g} ({worst[0]} "
        f"{worst[1]} on {worst[2]}); {time.perf_counter() - t:.3f} s")
    if worst[-1] > 1e-12 or len(names) != len(make_forest_fixtures.SCORE_NAMES):
        raise AssertionError(f"21 the score {worst[0]} {worst[1]} is {worst[-1]} from sklearn's")


def h5_windows(n, seed):
    """``n`` random TRAIN_PATCH windows of H5_VOLUME."""
    rng = np.random.default_rng(seed)
    highs = [v - p + 1 for v, p in zip(H5_VOLUME, TRAIN_PATCH)]
    return [tuple(slice(int(a), int(a) + p) for a, p in zip(rng.integers(0, highs), TRAIN_PATCH)) for _ in range(n)]


def lzf_tiles(rng):
    """H5_LZF_TILES (3, *H5_LZF_TILE) uint8 H&E-like tiles and uint32 label tiles: smooth noise, quantized, which
    LZF shrinks, and one tile of white noise, which it does not (the optional filter is skipped there)."""
    from scipy import ndimage

    he, inst = [], []
    for n in range(H5_LZF_TILES):
        field = ndimage.gaussian_filter(rng.random((3,) + H5_LZF_TILE, dtype=np.float32), (0, 6, 6))
        if n == H5_LZF_TILES - 1:
            he.append(rng.integers(0, 256, (3,) + H5_LZF_TILE, dtype=np.uint8))
        else:
            he.append(np.clip((field - field.mean()) * 2000 + 128, 0, 255).astype(np.uint8))
        inst.append((field[0] > field[0].mean()).astype(np.uint32) * (n + 1))
    return he, inst


def phase_hdf5(port, inorm):
    """HDF5 on the card with the port's own module (22a-d in the module docstring); returns the kernels' launches
    of the two training runs."""
    import glob
    import hashlib

    from torch_em_tpu_torch.ops.device import DeviceBoundaryTransform
    from torch_em_tpu_torch.ops.native import lzf
    from torch_em_tpu_torch.transforms.label import AffinityTransform
    from torch_em_tpu_torch.utils import hdf5, io

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    import torch_parity2d
    import torch_parity3d

    t_phase = time.perf_counter()
    stats = {}
    launches = [0, 0]
    with tempfile.TemporaryDirectory() as tmp:
        # 22a: bench.py's loader volume, written without a filter (as bench.py does) and with gzip (write_data)
        rng = np.random.default_rng(0)
        raw = rng.random(H5_VOLUME, dtype=np.float32)
        labels = rng.integers(1, 500, H5_VOLUME).astype("uint32")
        files = {"none": os.path.join(tmp, "vol.h5"), "gzip": os.path.join(tmp, "vol_gzip.h5")}
        t = time.perf_counter()
        with hdf5.File(files["none"], "w") as f:
            f.create_dataset("raw", data=raw, chunks=H5_CHUNKS)
            f.create_dataset("labels", data=labels, chunks=H5_CHUNKS)
        stats["write_none_s"] = time.perf_counter() - t
        t = time.perf_counter()
        io.write_data(files["gzip"], "raw", raw, chunks=H5_CHUNKS)
        io.write_data(files["gzip"], "labels", labels, chunks=H5_CHUNKS)
        stats["write_gzip_s"] = time.perf_counter() - t
        windows = h5_windows(H5_WINDOWS, 1)
        window_bytes = 2 * int(np.prod(TRAIN_PATCH)) * 4
        for key, path in files.items():
            stats[f"size_{key}_mib"] = os.path.getsize(path) / 2 ** 20
            with hdf5.File(path) as f:
                ds_raw, ds_labels = f["raw"], f["labels"]
                if (ds_raw.chunks, ds_labels.chunks, ds_raw.compression, ds_labels.dtype) != (
                        H5_CHUNKS, H5_CHUNKS, None if key == "none" else "gzip", np.dtype("uint32")):
                    raise AssertionError(f"22a {key}: {ds_raw.chunks} {ds_raw.compression} {ds_labels.dtype}")
                t = time.perf_counter()
                read = [(ds_raw[w], ds_labels[w]) for w in windows]
                seconds = time.perf_counter() - t
            stats[f"read_{key}_mb_per_s"] = window_bytes * len(windows) / seconds / 1e6
            for w, (r, lab) in zip(windows, read):
                if not (np.array_equal(r, raw[w]) and np.array_equal(lab, labels[w])):
                    raise AssertionError(f"22a {key}: the window {w} reads back otherwise than written")
            log(f"22a {key}: wrote raw and labels {H5_VOLUME} in {H5_CHUNKS} chunks in "
                f"{stats['write_' + key + '_s']:.2f} s, {stats['size_' + key + '_mib']:.1f} MiB; read {len(windows)} "
                f"random {TRAIN_PATCH} windows of both in {seconds:.3f} s, "
                f"{stats['read_' + key + '_mb_per_s']:.0f} MB/s, one thread, each equal to what was written")
        del raw, labels, read

        # 22b: the tracked model from SegmentationDataset over the h5 file, AffinityTransform on the host
        def h5_loader(path, n_samples, shuffle=True):
            dataset = port.SegmentationDataset(
                path, "raw", path, "labels", patch_shape=TRAIN_PATCH, n_samples=n_samples,
                label_transform=AffinityTransform(offsets=OFFSETS, add_mask=False))
            return port.DataLoader(dataset, batch_size=1, shuffle=shuffle, num_workers=LOADER_THREADS)

        np.random.seed(5)
        model = port.AnisotropicUNet(**TRACKED, device="cuda", seed=0)
        trainer = port.default_segmentation_trainer(
            "h5-tracked", model, h5_loader(files["none"], H5_FIT), h5_loader(files["none"], 1, shuffle=False),
            learning_rate=LEARNING_RATE, device="cuda", mixed_precision=True, logger=LossLog, save_root=tmp)
        resumed, fit_launches = fit_and_resume(port, inorm, trainer, H5_FIT, H5_RESUME, 1, "22b tracked model from h5",
                                               falling=False)
        launches = [launches[0] + fit_launches[0], launches[1] + fit_launches[1]]
        if resumed.train_loader.dataset.raw_path != files["none"]:
            raise AssertionError("22b from_checkpoint did not rebuild the h5 dataset")
        for key, path in files.items():
            stats[f"loader_{key}_patches_per_s"] = loader_rate(resumed, h5_loader(path, 2 + LOADER_STEPS))
        x, y = (v.cuda() for v in next(iter(h5_loader(files["none"], 1, shuffle=False))))
        stats["step_ms"] = time_ms(resumed._train_step, x, y, iters=10, repeats=1)
        npy = LOADER_RATES.get("7 no transform")
        log(f"22b loader, {LOADER_THREADS} thread workers, AffinityTransform on the host: "
            f"{stats['loader_none_patches_per_s']:.2f} patches/s from the unfiltered h5, "
            f"{stats['loader_gzip_patches_per_s']:.2f} from the gzip h5; bare step {stats['step_ms']:.2f} ms device "
            f"(CUDA events), {1e3 / stats['step_ms']:.2f} patches/s; phase 7's .npy loader (no transform, affinities "
            f"on the card) {'not run' if npy is None else f'{npy:.2f}'} patches/s; {nvidia_smi()}")
        del trainer, resumed, model, x, y
        torch.cuda.empty_cache()

        # 22c: the tracked parity files, read by the port, against the parity scripts' digests
        root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "experiments", "parity")
        parity = sorted(glob.glob(os.path.join(root, "parity_data*", "**", "*.h5"), recursive=True))
        if len(parity) != H5_PARITY_FILES:
            raise AssertionError(f"22c found {len(parity)} tracked parity files, not {H5_PARITY_FILES}")
        t = time.perf_counter()
        digests = {}
        for path in parity:
            with hdf5.File(path) as f:
                digests[os.path.relpath(path, root)] = hashlib.sha256(
                    np.ascontiguousarray(f["labels"][()], dtype=np.uint32).tobytes()).hexdigest()
        stats["parity_read_s"] = time.perf_counter() - t
        expected = {}
        for folder, scale in (("parity_data", "probe"), ("parity_data256", "tracked")):
            for split, digest in torch_parity2d.LABELS_SHA256[scale].items():
                expected[os.path.join(folder, f"{split}.h5")] = digest
        regenerated = torch_parity3d.make_data(os.path.join(tmp, "parity3d"))
        for split, volumes in regenerated.items():
            for i, (_, labels_path, _) in enumerate(volumes):
                expected[os.path.join("parity_data3d", split, f"vol{i}.h5")] = torch_parity3d.labels_digest(
                    np.load(labels_path))
        if digests != expected:
            differ = sorted(k for k in set(digests) | set(expected) if digests.get(k) != expected.get(k))
            raise AssertionError(f"22c labels sha256 differ from the parity scripts' for {differ}")
        log(f"22c read the labels of all {len(parity)} tracked parity h5 files in {stats['parity_read_s']:.2f} s; "
            f"each sha256 equals the parity scripts' (torch_parity2d.LABELS_SHA256, torch_parity3d.make_data)")
        train3d = sorted(glob.glob(os.path.join(root, "parity_data3d", "train", "vol*.h5")))

        def probe_loader(n_samples, shuffle=True):
            return port.default_segmentation_loader(
                train3d, "raw", train3d, "labels", batch_size=1, patch_shape=torch_parity3d.PATCH, ndim=3,
                label_dtype="float32", n_samples=n_samples, shuffle=shuffle, num_workers=LOADER_THREADS)

        model = port.AnisotropicUNet(in_channels=1, out_channels=1, initial_features=SNEMI_PROBE_FEATURES,
                                     scale_factors=SNEMI_PROBE_SCALES, final_activation="Sigmoid", device="cuda",
                                     seed=0)
        trainer = port.default_segmentation_trainer(
            "h5-probe3d", model, probe_loader(H5_PROBE_FIT), probe_loader(1, shuffle=False), learning_rate=1e-4,
            device="cuda", logger=LossLog, save_root=tmp, device_label_transform=DeviceBoundaryTransform(ndim=3))
        resumed, fit_launches = fit_and_resume(port, inorm, trainer, H5_PROBE_FIT, H5_PROBE_RESUME, 1,
                                               "22c 3-D probe model over parity_data3d/train/vol*.h5",
                                               norms=(SNEMI_PROBE_NORMS, SNEMI_PROBE_NORMS - 1), falling=False)
        launches = [launches[0] + fit_launches[0], launches[1] + fit_launches[1]]
        if len(resumed.train_loader.dataset.datasets) != len(train3d):
            raise AssertionError("22c from_checkpoint did not rebuild the loader over the six volumes")
        del trainer, resumed, model

        # 22d: an LZF-filtered dataset grown along its unlimited axis tile by tile, as orion_crc.py writes it
        t = time.perf_counter()
        library = lzf.load_library()._name
        stats["lzf_build_s"] = time.perf_counter() - t
        he, inst = lzf_tiles(np.random.default_rng(2))
        path = os.path.join(tmp, "tiles.h5")
        t = time.perf_counter()
        with hdf5.File(path, "w") as f:
            f.attrs["slide_name"] = "smoke"
            he_ds = f.create_dataset("images/he", shape=(3, 0) + H5_LZF_TILE, maxshape=(3, None) + H5_LZF_TILE,
                                     compression="lzf", chunks=(3, 1) + H5_LZF_TILE, dtype="uint8")
            inst_ds = f.create_dataset("labels/instances", shape=(0,) + H5_LZF_TILE, maxshape=(None,) + H5_LZF_TILE,
                                       compression="lzf", chunks=(1,) + H5_LZF_TILE, dtype="uint32")
            for n in range(H5_LZF_TILES):
                he_ds.resize(n + 1, axis=1)
                inst_ds.resize(n + 1, axis=0)
                he_ds[:, n] = he[n]
                inst_ds[n] = inst[n]
        stats["lzf_write_s"] = time.perf_counter() - t
        with hdf5.File(path) as f:
            he_back, inst_back = f["images/he"][...], f["labels/instances"][...]
            masks = [mask for _, _, mask in f["images/he"]._state().chunk_index().values()]
            ok = (f.attrs["slide_name"] == "smoke" and f["images/he"].compression == "lzf"
                  and np.array_equal(he_back, np.stack(he, axis=1)) and np.array_equal(inst_back, np.stack(inst)))
        raw_bytes = sum(a.nbytes for a in he + inst)
        log(f"22d LZF: {library} built and loaded in {stats['lzf_build_s']:.2f} s; {H5_LZF_TILES} tiles grown along "
            f"the unlimited axis in {stats['lzf_write_s']:.2f} s, {os.path.getsize(path) / raw_bytes:.3f} of their "
            f"{raw_bytes / 2 ** 20:.1f} MiB; {masks.count(1)} of {len(masks)} H&E chunks stored unfiltered (LZF "
            f"would not shrink them); read back equal: {ok}")
        if not ok or masks.count(1) != 1:
            raise AssertionError("22d the LZF tiles do not read back as written")
    log(f"22: {launches[0]} forward and {launches[1]} backward norm launches; phase {time.perf_counter() - t_phase:.1f} s; "
        f"numbers {json.dumps({k: round(v, 3) for k, v in stats.items()})}")
    return launches


def folder_mib(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path) for f in files) / 2 ** 20


def block_labels(shape, block, offset=0):
    """Instance labels of ``shape``: boxes of ``block``, numbered in C order from ``offset`` + 1."""
    grid = np.indices(shape, sparse=True)
    ids = np.zeros(shape, dtype=np.int64)
    stride = 1
    for axis in reversed(range(len(shape))):
        ids = ids + (grid[axis] // block[axis]) * stride
        stride *= -(-shape[axis] // block[axis])
    return ids + offset + 1


def phase_zarr_n5(port, inorm):
    """zarr and N5 on the card with the port's own module (23a-e in the module docstring), with tensorstore, zarr and
    h5py blocked; returns the kernels' launches of its training runs and predictions."""
    import glob
    import importlib.util

    from torch_em_tpu_torch import cli
    from torch_em_tpu_torch.data.datasets import get_platynereis_cell_loader, get_tissuenet_loader
    from torch_em_tpu_torch.ops.native import blosc
    from torch_em_tpu_torch.transforms.label import AffinityTransform, BoundaryTransform
    from torch_em_tpu_torch.transforms.raw import standardize
    from torch_em_tpu_torch.utils import io, zarr_n5
    from torch_em_tpu_torch.utils.prediction import predict_with_padding
    from torch_em_tpu_torch.utils.util import get_trainer

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    import make_zarr_n5_fixtures as fixtures
    import torch_parity3d

    installed = [name for name in ZN_BLOCKED if importlib.util.find_spec(name) is not None]
    blocked = [name for name in ZN_BLOCKED if name not in sys.modules]
    for name in blocked:
        sys.modules[name] = None  # an import of it raises
    t_phase = time.perf_counter()
    stats = {}
    launches = [0, 0]
    try:
        t = time.perf_counter()
        library = blosc.load_library()._name
        stats["blosc_build_s"] = time.perf_counter() - t
        log(f"23 blosc: {library} built and loaded in {stats['blosc_build_s']:.2f} s; installed here of "
            f"{', '.join(ZN_BLOCKED)}: {installed or 'none'}; blocked for the phase: {blocked}")
        with tempfile.TemporaryDirectory() as tmp:
            # 23a: phase 22's volume written as zarr and as N5 (blosc lz4) and read back in random windows
            rng = np.random.default_rng(0)
            raw = rng.random(H5_VOLUME, dtype=np.float32)
            labels = rng.integers(1, 500, H5_VOLUME).astype("uint32")
            stores = {"zarr": os.path.join(tmp, "vol.zarr"), "n5": os.path.join(tmp, "vol.n5")}
            windows = h5_windows(H5_WINDOWS, 1)
            window_bytes = 2 * int(np.prod(TRAIN_PATCH)) * 4
            for fmt, path in stores.items():
                t = time.perf_counter()
                io.write_data(path, "raw", raw, chunks=H5_CHUNKS)
                io.write_data(path, "labels", labels, chunks=H5_CHUNKS)
                stats[f"write_{fmt}_s"] = time.perf_counter() - t
                stats[f"size_{fmt}_mib"] = folder_mib(path)
                ds_raw, ds_labels = io.load_data(path, "raw"), io.load_data(path, "labels")
                with open(os.path.join(path, "raw", ".zarray" if fmt == "zarr" else "attributes.json")) as f:
                    codec = json.load(f)["compressor" if fmt == "zarr" else "compression"]
                if (ds_raw.chunks, ds_labels.chunks, ds_labels.dtype, codec["cname"]) != (
                        H5_CHUNKS, H5_CHUNKS, np.dtype("uint32"), "lz4"):
                    raise AssertionError(f"23a {fmt}: {ds_raw.chunks} {ds_labels.dtype} {codec}")
                for threads in (1, zarr_n5.THREADS):
                    with unittest.mock.patch.object(zarr_n5, "THREADS", threads):
                        t = time.perf_counter()
                        read = [(ds_raw[w], ds_labels[w]) for w in windows]
                        seconds = time.perf_counter() - t
                    stats[f"read_{fmt}_{threads}_mb_per_s"] = window_bytes * len(windows) / seconds / 1e6
                    for w, (r, lab) in zip(windows, read):
                        if not (np.array_equal(r, raw[w]) and np.array_equal(lab, labels[w])):
                            raise AssertionError(f"23a {fmt}: the window {w} reads back otherwise than written")
                log(f"23a {fmt}: wrote raw and labels {H5_VOLUME} in {H5_CHUNKS} chunks (blosc lz4, shuffle "
                    f"{codec['shuffle']}) in {stats[f'write_{fmt}_s']:.2f} s, {stats[f'size_{fmt}_mib']:.1f} MiB; read "
                    f"{len(windows)} random {TRAIN_PATCH} windows of both from one thread: "
                    f"{stats[f'read_{fmt}_1_mb_per_s']:.0f} MB/s decoding each window's chunks one after another, "
                    f"{stats[f'read_{fmt}_{zarr_n5.THREADS}_mb_per_s']:.0f} MB/s on {zarr_n5.THREADS} threads; each "
                    "equal to what was written")
            del read

            # 23b: the tracked model from SegmentationDataset over the zarr volume, AffinityTransform on the host
            def zn_loader(path, n_samples, shuffle=True, mode="thread", workers=LOADER_THREADS):
                dataset = port.SegmentationDataset(
                    path, "raw", path, "labels", patch_shape=TRAIN_PATCH, n_samples=n_samples,
                    label_transform=AffinityTransform(offsets=OFFSETS, add_mask=False))
                return port.DataLoader(dataset, batch_size=1, shuffle=shuffle, num_workers=workers, worker_mode=mode)

            np.random.seed(6)
            model = port.AnisotropicUNet(**TRACKED, device="cuda", seed=0)
            trainer = port.default_segmentation_trainer(
                "zarr-tracked", model, zn_loader(stores["zarr"], H5_FIT), zn_loader(stores["zarr"], 1, shuffle=False),
                learning_rate=LEARNING_RATE, device="cuda", mixed_precision=True, logger=LossLog, save_root=tmp)
            resumed, fit_launches = fit_and_resume(port, inorm, trainer, H5_FIT, H5_RESUME, 1,
                                                   "23b tracked model from zarr", falling=False)
            launches = [launches[0] + fit_launches[0], launches[1] + fit_launches[1]]
            if resumed.train_loader.dataset.raw_path != stores["zarr"]:
                raise AssertionError("23b from_checkpoint did not rebuild the zarr dataset")
            for fmt, path in stores.items():
                stats[f"loader_{fmt}_patches_per_s"] = loader_rate(resumed, zn_loader(path, 2 + LOADER_STEPS))
            x, y = (v.cuda() for v in next(iter(zn_loader(stores["zarr"], 1, shuffle=False))))
            stats["step_ms"] = time_ms(resumed._train_step, x, y, iters=10, repeats=1)
            npy = LOADER_RATES.get("7 no transform")
            log(f"23b loader, {LOADER_THREADS} thread workers, AffinityTransform on the host: "
                f"{stats['loader_zarr_patches_per_s']:.2f} patches/s from zarr, {stats['loader_n5_patches_per_s']:.2f} "
                f"from N5; bare step {stats['step_ms']:.2f} ms device (CUDA events), {1e3 / stats['step_ms']:.2f} "
                f"patches/s; phase 7's .npy loader (no transform, affinities on the card) "
                f"{'not run' if npy is None else f'{npy:.2f}'} patches/s; {nvidia_smi()}")
            # the N5 volume's lazy arrays pickled into spawned worker processes, and their batches into the steps
            feed = zn_loader(stores["n5"], ZN_PROCESS_BATCHES, shuffle=False, mode="process", workers=ZN_PROCESS_WORKERS)
            try:
                t = time.perf_counter()
                batches = 0
                for xb, yb in feed:
                    resumed._train_step(xb.cuda(), yb.cuda())
                    batches += 1
                torch.cuda.synchronize()
                stats["process_s"] = time.perf_counter() - t
            finally:
                feed.shutdown()
            if batches != ZN_PROCESS_BATCHES:
                raise AssertionError(f"23b the process workers gave {batches} batches")
            log(f"23b {batches} batches of the N5 volume through {ZN_PROCESS_WORKERS} spawned worker processes (the "
                f"lazy arrays pickled as path, key and mode) into the steps in {stats['process_s']:.2f} s, the "
                "workers' start included")
            checkpoint = resumed.checkpoint_folder
            del trainer, resumed, model, x, y
            torch.cuda.empty_cache()

            # 23c: the committed tensorstore fixtures, decoded by the card's native build
            t = time.perf_counter()
            for case in fixtures.CASES:
                got = io.load_data(fixtures.container(case["fmt"]), case["name"])
                expected = fixtures.fixture_array(case)
                if got.dtype != expected.dtype or not np.array_equal(got[...], expected):
                    raise AssertionError(f"23c the fixture {case['fmt']}/{case['name']} reads otherwise than its array")
            stats["fixtures_s"] = time.perf_counter() - t
            codecs = sorted({case["name"].split("_shuffle")[0] for case in fixtures.CASES})
            log(f"23c read all {len(fixtures.CASES)} fixtures that tensorstore (c-blosc) wrote, each equal to its "
                f"seeded array, in {stats['fixtures_s']:.2f} s: {', '.join(codecs)}")

            # 23d: the CLI's predict from the zarr raw to N5, against predict_with_padding in this process
            crop = tuple(slice(0, p) for p in TRAIN_PATCH)
            io.write_data(stores["zarr"], "raw_patch", raw[crop], chunks=H5_CHUNKS)
            out = os.path.join(tmp, "pred.n5")
            argv = ["predict", "-c", checkpoint, "-i", stores["zarr"], "-k", "raw_patch", "-o", out,
                    "--output_key", "pred", "--chunks", *map(str, ZN_PRED_CHUNKS), "--min_divisible",
                    *map(str, ZN_MIN_DIVISIBLE), "-d", "cuda"]
            inorm.instance_norm.launches = 0
            with torch_parity3d.deterministic():
                t = time.perf_counter()
                with unittest.mock.patch.object(sys, "argv", argv):
                    cli.predict()
                stats["cli_s"] = time.perf_counter() - t
                model = get_trainer(checkpoint, device="cuda").model
                expected = predict_with_padding(model, standardize(raw[crop]), ZN_MIN_DIVISIBLE, "cuda").squeeze()
            launches[0] += inorm.instance_norm.launches
            pred = io.load_data(out, "pred")
            with open(os.path.join(out, "pred", "attributes.json")) as f:
                meta = json.load(f)
            got = pred[...]
            err = float(np.abs(got - expected).max())
            log(f"23d CLI predict ({stats['cli_s']:.2f} s): {TRAIN_PATCH} of the zarr raw to {meta['dataType']} "
                f"N5 {pred.shape} in blockSize {meta['blockSize']} (x first); against predict_with_padding in this "
                f"process, deterministic algorithms: bitwise equal {np.array_equal(got, expected)}, max abs diff {err:.3g}; "
                f"{inorm.instance_norm.launches} forward norm launches")
            if (pred.shape != TRAIN_PATCH or pred.chunks != ZN_PRED_CHUNKS or not np.array_equal(got, expected)
                    or not np.isfinite(got).all()):
                raise AssertionError("23d the CLI's N5 prediction differs from predict_with_padding's")
            del model, raw, labels
            torch.cuda.empty_cache()

            # 23e: the zoo's platynereis cells (N5) and TissueNet (zarr, through its own conversion) into their models
            platy = os.path.join(tmp, "platynereis")
            t = time.perf_counter()
            for i in range(1, ZN_PLATY_FILES + 1):
                path = os.path.join(platy, "membrane", f"train_data_membrane_{i:02d}.n5")
                io.write_data(path, "volumes/raw/s1", rng.integers(0, 256, ZN_PLATY_VOLUME, dtype=np.uint8))
                io.write_data(path, "volumes/labels/segmentation/s1",
                              block_labels(ZN_PLATY_VOLUME, (8, 40, 40), offset=1000 * i).astype("uint64"),
                              chunks=(8, 64, 64))
            stats["platy_write_s"] = time.perf_counter() - t

            def platy_loader(sample_ids, n_samples, shuffle=True):
                return get_platynereis_cell_loader(platy, TRAIN_PATCH, 1, sample_ids=sample_ids, boundaries=True,
                                                   n_samples=n_samples, shuffle=shuffle, num_workers=LOADER_THREADS)

            np.random.seed(7)
            model = port.AnisotropicUNet(**TRACKED, device="cuda", seed=0)
            trainer = port.default_segmentation_trainer(
                "platynereis-n5", model, platy_loader(list(range(1, ZN_PLATY_FILES)), ZN_ZOO_FIT),
                platy_loader([ZN_PLATY_FILES], 1, shuffle=False), learning_rate=LEARNING_RATE, device="cuda",
                mixed_precision=True, logger=LossLog, save_root=tmp)
            resumed, fit_launches = fit_and_resume(port, inorm, trainer, ZN_ZOO_FIT, ZN_ZOO_RESUME, 1,
                                                   "23e platynereis cells (N5)", falling=False)
            launches = [launches[0] + fit_launches[0], launches[1] + fit_launches[1]]
            log(f"23e platynereis: {ZN_PLATY_FILES} N5 volumes {ZN_PLATY_VOLUME} (uint8 raw, uint64 labels) written in "
                f"{stats['platy_write_s']:.2f} s, {folder_mib(platy):.1f} MiB; get_platynereis_cell_loader "
                f"(boundaries) into the tracked model")
            del trainer, resumed, model

            tissue = os.path.join(tmp, "tissuenet")
            os.makedirs(tissue)
            side = ZN_TISSUENET_SIDE
            images = {}
            for split, n in zip(("train", "val"), ZN_TISSUENET):
                x = rng.random((n, side, side, 2), dtype=np.float32)
                y = np.stack([block_labels((n, side, side), (1, 32, 32)), block_labels((n, side, side), (1, 16, 16))],
                             axis=-1).astype("int32")
                np.savez(os.path.join(tissue, f"tissuenet_v1.1_{split}.npz"), X=x, y=y)
                images[split] = x

            def tissue_loader(split, n_samples, shuffle=True):
                return get_tissuenet_loader(tissue, split, patch_shape=DSB_PATCH[1:], batch_size=DSB_BATCH,
                                            label_transform=BoundaryTransform(add_binary_target=True, ndim=2),
                                            n_samples=n_samples, shuffle=shuffle, num_workers=LOADER_THREADS)

            t = time.perf_counter()
            train = tissue_loader("train", DSB_BATCH * ZN_ZOO_FIT)
            stats["tissuenet_convert_s"] = time.perf_counter() - t
            converted = sorted(glob.glob(os.path.join(tissue, "train", "*.zarr")))
            if len(converted) != ZN_TISSUENET[0] or not np.array_equal(io.load_data(converted[-1], "raw/cell")[...],
                                                                       images["train"][-1, ..., 1]):
                raise AssertionError(f"23e TissueNet converted {len(converted)} train images, or not as given")
            np.random.seed(8)
            model = port.UNet2d(**DSB_MODEL, device="cuda", seed=0)
            trainer = port.default_segmentation_trainer(
                "tissuenet-zarr", model, train, tissue_loader("val", DSB_BATCH, shuffle=False),
                learning_rate=LEARNING_RATE, device="cuda", mixed_precision=True, logger=LossLog, save_root=tmp)
            resumed, fit_launches = fit_and_resume(port, inorm, trainer, ZN_ZOO_FIT, ZN_ZOO_RESUME, 1,
                                                   "23e TissueNet (zarr)", falling=False)
            launches = [launches[0] + fit_launches[0], launches[1] + fit_launches[1]]
            log(f"23e TissueNet: {sum(ZN_TISSUENET)} images {side}x{side}x2 converted from npz to zarr by the reader "
                f"in {stats['tissuenet_convert_s']:.2f} s ({len(converted)} train containers, each read back as "
                f"given); get_tissuenet_loader (boundaries, batch {DSB_BATCH} of {DSB_PATCH[1:]}) into UNet2d f="
                f"{DSB_MODEL['initial_features']}")
            del trainer, resumed, model, train
            torch.cuda.empty_cache()
    finally:
        for name in blocked:
            del sys.modules[name]
    log(f"23: {launches[0]} forward and {launches[1]} backward norm launches; phase {time.perf_counter() - t_phase:.1f} s; "
        f"numbers {json.dumps({k: round(v, 3) for k, v in stats.items()})}")
    return launches


def read_log(folder):
    """{tag: [(step, value), ...]} of every event file of a log folder, read by the port's own reader (both CRCs of
    every record checked)."""
    from torch_em_tpu_torch.utils.tensorboard import read_events

    events = {}
    for _, step, tag, value in read_events(folder):
        events.setdefault(tag, []).append((step, value))
    return events


def decoded_shape(image):
    """The (H, W, C) shape of a logged image's PNG, decoded by PIL; its stored height and width must agree."""
    import io

    from PIL import Image as PILImage

    shape = np.asarray(PILImage.open(io.BytesIO(image.encoded_image_string))).shape
    if (image.height, image.width, image.colorspace) != shape:
        raise AssertionError(f"an image stored as {image.height}x{image.width}x{image.colorspace} decodes to {shape}")
    return shape


def keep_losses(trainer, losses):
    """Append each step's loss, the value the trainer hands to its logger, to ``losses``."""
    step = trainer._train_step

    def kept(*batch):
        out = step(*batch)
        if out is not None:
            losses.append(float(out[0]))
        return out

    trainer._train_step = kept


def timed_epochs(trainer, times):
    """Append the seconds per iteration of each of the trainer's training epochs to ``times``."""
    epoch = trainer._train_epoch

    def timed(*args, **kwargs):
        times.append(epoch(*args, **kwargs))
        return times[-1]

    trainer._train_epoch = timed


# the tags that each trainer's default logger writes, as the JAX package's loggers name them
LOG_SEGMENTATION_TAGS = {"train/loss", "train/learning_rate", "validation/loss", "validation/metric", "train/input",
                         "train/target", "train/prediction", "validation/input", "validation/target",
                         "validation/prediction"}
LOG_SELF_TRAINING_TAGS = {"train/unsupervised/loss", "train/learning_rate", "train/confidence_threshold",
                          "train/unsupervised/overview", "validation/unsupervised/loss",
                          "validation/unsupervised/metric", "validation/unsupervised/overview"}
LOG_CLASSIFICATION_TAGS = {"train/loss", "train/learning_rate", "train/input", "validation/loss", "validation/metric",
                           "validation/input", "validation/confusion_matrix"}


def phase_logs_hdbscan(port, inorm, device_ops):
    """Training logs with the trainers' default loggers and HDBSCAN on the card, with tensorboardX, tensorboard,
    sklearn and matplotlib blocked (24a-c in the module docstring); returns the kernels' launches of its fits."""
    import glob
    import importlib.util
    import inspect

    from torch_em_tpu_torch import self_training as st
    from torch_em_tpu_torch.data import RawImageCollectionDataset
    from torch_em_tpu_torch.loss import ContrastiveLoss, SPOCOLoss
    from torch_em_tpu_torch.metric import HDBScanRandMetric
    from torch_em_tpu_torch.ops import native
    from torch_em_tpu_torch.ops.native import crc32c
    from torch_em_tpu_torch.trainer import SPOCOTrainer
    from torch_em_tpu_torch.transforms import connected_components, get_default_mean_teacher_augmentations

    installed = [name for name in LOG_BLOCKED if importlib.util.find_spec(name) is not None]
    blocked = [name for name in LOG_BLOCKED if name not in sys.modules]
    for name in blocked:
        sys.modules[name] = None  # an import of it raises
    t_phase = time.perf_counter()
    stats = {}
    torch.cuda.synchronize()
    inorm.instance_norm.launches = inorm.instance_norm_backward.launches = 0
    try:
        log(f"24: installed here of {', '.join(LOG_BLOCKED)}: {installed or 'none'}; blocked for the phase: "
            f"{blocked}; CRC-32C {crc32c.load_library()._name}, HDBSCAN {native.load_hdbscan_library()._name}")
        with tempfile.TemporaryDirectory() as tmp:
            # 24a: the tracked model with the default logger, against logger=None in turns
            raw, labels = training_volume(port)
            np.save(os.path.join(tmp, "raw.npy"), raw)
            np.save(os.path.join(tmp, "labels.npy"), labels)
            del raw, labels

            def volume_loader(n_samples, shuffle):
                ds = port.SegmentationDataset(
                    os.path.join(tmp, "raw.npy"), None, os.path.join(tmp, "labels.npy"), None, patch_shape=TRAIN_PATCH,
                    n_samples=n_samples, raw_transform=port.standardize)
                return port.DataLoader(ds, batch_size=1, shuffle=shuffle, num_workers=LOADER_THREADS)

            def tracked(name, iterations=LOG_FIT, log_image_interval=LOG_IMAGES, **logger):
                np.random.seed(0)
                model = port.AnisotropicUNet(**TRACKED, device="cuda", seed=0)
                return port.default_segmentation_trainer(
                    name, model, volume_loader(iterations, True), volume_loader(VAL_SAMPLES, False),
                    learning_rate=LEARNING_RATE, log_image_interval=log_image_interval, save_root=tmp,
                    device_label_transform=device_ops.DeviceAffinityTransform(offsets=OFFSETS), **logger)

            def in_turns(label, iterations, losses=None, **kwargs):
                """{kind: [s per iteration of each training epoch]} of LOG_PAIRS fits with the default logger and
                as many with logger=None, in turns, each a fresh trainer, and the first default trainer (whose losses
                go to ``losses``)."""
                times, first = {"default logger": [], "logger=None": []}, None
                for pair in range(LOG_PAIRS):
                    for kind in (("default logger", "logger=None") if pair % 2 == 0 else
                                 ("logger=None", "default logger")):
                        logger = {} if kind == "default logger" else {"logger": None}
                        trainer = tracked(f"{label}_{kind.split()[0].replace('=', '_')}_{pair}", iterations,
                                          **kwargs, **logger)
                        timed_epochs(trainer, times[kind])
                        if first is None and kind == "default logger":
                            first = trainer
                            if losses is not None:
                                keep_losses(trainer, losses)
                        trainer.fit(iterations=iterations)
                        torch.cuda.synchronize()
                return times, first

            warm = tracked("logs_warm_up", logger=None)
            warm.fit(iterations=2)
            del warm
            losses = []
            times, checked = in_turns("logs", LOG_FIT, losses)
            if not isinstance(checked.logger, port.trainer.TensorboardLogger):
                raise AssertionError(f"24a: the default logger is {type(checked.logger)}")
            resumed = port.DefaultTrainer.from_checkpoint(checked.checkpoint_folder, "latest")
            keep_losses(resumed, losses)
            resumed.fit(iterations=LOG_RESUME)
            torch.cuda.synchronize()
            steps = LOG_FIT + LOG_RESUME
            events = read_log(checked.logger.log_dir)
            scalar_steps = {tag: [step for step, _ in events.get(tag, [])] for tag in
                            ("train/loss", "train/learning_rate", "validation/loss", "validation/metric")}
            expected_steps = {"train/loss": list(range(steps)), "train/learning_rate": list(range(steps)),
                              "validation/loss": [LOG_FIT, steps], "validation/metric": [LOG_FIT, steps]}
            if set(events) != LOG_SEGMENTATION_TAGS or scalar_steps != expected_steps:
                raise AssertionError(f"24a: tags {sorted(events)}, scalar steps {scalar_steps}")
            logged = [value for _, value in events["train/loss"]]
            if logged != [float(np.float32(v)) for v in losses]:
                raise AssertionError(f"24a: logged losses {logged}, the trainer's {losses}")
            image_steps = {tag: [step for step, _ in events[tag]] for tag in ("train/input", "train/target",
                                                                                 "train/prediction")}
            if any(v != list(range(0, steps, LOG_IMAGES)) for v in image_steps.values()):
                raise AssertionError(f"24a: train images at {image_steps}")
            panel = (TRAIN_PATCH[1] + 4, TRAIN_PATCH[2] + 4)
            shapes = {tag: decoded_shape(value) for tag, series in events.items() for _, value in series
                      if not isinstance(value, float)}
            if shapes["train/input"] != panel + (3,) or any(h != panel[0] or w % panel[1] or c != 3
                                                            for h, w, c in shapes.values()):
                raise AssertionError(f"24a: image shapes {shapes}")
            ms = {kind: float(np.mean(v)) * 1e3 for kind, v in times.items()}
            stats["24a"] = {"ms_per_iteration": ms, "runs_ms": {k: [t * 1e3 for t in v] for k, v in times.items()},
                            "ratio": ms["default logger"] / ms["logger=None"],
                            "files": sorted(os.listdir(checked.logger.log_dir))}
            log(f"24a tracked model, default logger: {steps} train/loss equal to the trainer's losses in float32, "
                f"learning rates, validations at {expected_steps['validation/loss']}, images at "
                f"{image_steps['train/input']} decoding to {shapes['train/input']} (PNG in the event file); training "
                f"epochs {ms['default logger']:.2f} ms per iteration with the default logger against "
                f"{ms['logger=None']:.2f} with logger=None ({stats['24a']['ratio']:.3f}x; {LOG_PAIRS} fits of "
                f"{LOG_FIT} each, in turns; runs {stats['24a']['runs_ms']}); {nvidia_smi()}")
            del checked, resumed
            # the same at the default cadence: a fit as long as the default log_image_interval, images at its start
            cadence = inspect.signature(port.default_segmentation_trainer).parameters["log_image_interval"].default
            times, _ = in_turns("cadence", cadence, log_image_interval=cadence)
            ms = {kind: float(np.mean(v)) * 1e3 for kind, v in times.items()}
            stats["24a default cadence"] = {
                "iterations": cadence, "ms_per_iteration": ms, "ratio": ms["default logger"] / ms["logger=None"],
                "runs_ms": {k: [t * 1e3 for t in v] for k, v in times.items()}}
            log(f"24a at the default log_image_interval ({cadence}, fits of {cadence} iterations): training epochs "
                f"{ms['default logger']:.2f} ms per iteration with the default logger against {ms['logger=None']:.2f} "
                f"with logger=None ({stats['24a default cadence']['ratio']:.3f}x; runs "
                f"{stats['24a default cadence']['runs_ms']}); {nvidia_smi()}")

            # 24b: SPOCO, MeanTeacher and classification with their default loggers
            raw_files, label_files = dsb_images(os.path.join(tmp, "dsb"))
            adamw = port.OptimizerSpec("adamw", lr=LEARNING_RATE)

            def dsb_loader(n_samples, shuffle=True):
                return port.default_segmentation_loader(
                    raw_files, None, label_files, None, batch_size=DSB_BATCH, patch_shape=DSB_PATCH, ndim=2,
                    is_seg_dataset=False, label_transform=connected_components, label_dtype="int32",
                    num_workers=LOADER_THREADS, shuffle=shuffle, n_samples=n_samples)

            views = get_default_mean_teacher_augmentations()

            def unlabelled(n_samples, shuffle=True):
                dataset = RawImageCollectionDataset(raw_files, DSB_PATCH[1:], augmentations=(views, views),
                                                    n_samples=n_samples)
                return port.DataLoader(dataset, batch_size=DSB_BATCH, shuffle=shuffle, num_workers=LOADER_THREADS)

            cls = port.classification
            train_volumes = classification_volumes(CLS_BATCH * LOG_ST_FIT, 19)
            val_volumes = classification_volumes(CLS_BATCH, 20)
            builds = (
                ("SPOCOTrainer", LOG_SEGMENTATION_TAGS, "train/loss", lambda: SPOCOTrainer(
                    name="spoco_logs", model=port.UNet2d(**SPOCO_MODEL, depth=SPOCO_DEPTH, device="cuda", seed=0),
                    train_loader=dsb_loader(DSB_BATCH * LOG_ST_FIT), val_loader=dsb_loader(DSB_BATCH, False),
                    loss=SPOCOLoss(**SPOCO_LOSS), metric=ContrastiveLoss(**SPOCO_LOSS), optimizer=adamw,
                    momentum=SPOCO_MOMENTUM, mixed_precision=True, device="cuda", save_root=tmp)),
                ("MeanTeacherTrainer", LOG_SELF_TRAINING_TAGS, "train/unsupervised/loss", lambda: st.MeanTeacherTrainer(
                    name="mean_teacher_logs", model=port.UNet2d(**DSB_MODEL, depth=DSB_DEPTH, device="cuda", seed=0),
                    unsupervised_train_loader=unlabelled(DSB_BATCH * LOG_ST_FIT),
                    unsupervised_val_loader=unlabelled(DSB_BATCH, False),
                    unsupervised_loss=st.DefaultSelfTrainingLoss(),
                    unsupervised_loss_and_metric=st.DefaultSelfTrainingLossAndMetric(),
                    pseudo_labeler=st.DefaultPseudoLabeler(confidence_threshold=ST_CT), optimizer=adamw,
                    mixed_precision=True, device="cuda", save_root=tmp)),
                ("default_classification_trainer", LOG_CLASSIFICATION_TAGS, "train/loss",
                 lambda: cls.default_classification_trainer(
                     "resnet3d_logs", port.resnet3d_50(1, CLS_CLASSES),
                     cls.default_classification_loader(*train_volumes, batch_size=CLS_BATCH, shuffle=True,
                                                       num_workers=LOADER_THREADS),
                     cls.default_classification_loader(*val_volumes, batch_size=CLS_BATCH,
                                                       num_workers=LOADER_THREADS),
                     learning_rate=1e-3, save_root=tmp)),
            )
            spoco = None
            for label, tags, loss_tag, build in builds:
                trainer = build()
                t = time.perf_counter()
                trainer.fit(iterations=LOG_ST_FIT)
                resumed = port.DefaultTrainer.from_checkpoint(trainer.checkpoint_folder, "latest")
                resumed.fit(iterations=LOG_ST_RESUME)
                torch.cuda.synchronize()
                fit_s = time.perf_counter() - t
                events = read_log(trainer.logger.log_dir)
                loss_steps = [step for step, _ in events.get(loss_tag, [])]
                values = [v for _, v in events.get(loss_tag, [])]
                if set(events) != tags or loss_steps != list(range(LOG_ST_FIT + LOG_ST_RESUME)) \
                        or not np.all(np.isfinite(values)):
                    raise AssertionError(f"24b {label}: tags {sorted(events)}, {loss_tag} {events.get(loss_tag)}")
                shapes = {tag: decoded_shape(series[-1][1]) for tag, series in events.items()
                          if not isinstance(series[-1][1], float)}
                stats[f"24b {label}"] = {"logger": type(trainer.logger).__name__, "fit_s": fit_s,
                                         "images": {k: list(v) for k, v in shapes.items()}}
                log(f"24b {label}: default logger {type(trainer.logger).__name__}, fit {LOG_ST_FIT} + "
                    f"{LOG_ST_RESUME} in {fit_s:.2f} s; {len(events)} tags as the JAX logger's, {loss_tag} "
                    f"{[round(v, 4) for v in values]}, images {shapes}")
                if label == "SPOCOTrainer":
                    spoco = resumed.model.eval()
                del trainer, resumed

            # 24c: the committed sklearn fixtures, then HDBScanRandMetric on the SPOCO recipe's embeddings
            fixtures = sorted(glob.glob(os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", "records",
                                                     "hdbscan", "*.npz")))
            if not fixtures:
                raise AssertionError("24c: no HDBSCAN fixtures under scripts/records/hdbscan")
            results = {}
            for path in fixtures:
                case = np.load(path)
                m, eps = int(case["min_cluster_size"]), float(case["cluster_selection_epsilon"])
                src, dst, weight = native.hdbscan_mst(case["points"], m)
                tree = (np.array_equal(src, case["mst_src"]) and np.array_equal(dst, case["mst_dst"])
                        and np.array_equal(weight, case["mst_weight"]))
                order = case["order"]
                from_order = native.hdbscan_labels(src[order], dst[order], weight[order], m, eps)
                same_order = np.array_equal(np.argsort(weight), order)
                got = native.hdbscan(case["points"], m, eps)
                equal = np.array_equal(got, case["labels"])
                name = os.path.basename(path)[:-4]
                results[name] = {"tree_bitwise": tree, "labels_from_sklearn_order": np.array_equal(
                    from_order, case["labels"]), "argsort_order_as_recorded": same_order, "labels": equal,
                    "tie_order_free": bool(case["tie_order_free"])}
                if not (tree and results[name]["labels_from_sklearn_order"]) or \
                        (not equal and (same_order or bool(case["tie_order_free"]))):
                    raise AssertionError(f"24c {name}: {results[name]}")
            stats["24c fixtures"] = results
            log(f"24c: {len(fixtures)} sklearn {str(np.load(fixtures[0])['sklearn_version'])} fixtures (numpy "
                f"{str(np.load(fixtures[0])['numpy_version'])} there, {np.__version__} here): {json.dumps(results)}")
            images = np.stack([port.standardize(np.load(f)[:HDBSCAN_CROP[0], :HDBSCAN_CROP[1]])
                               for f in raw_files[:HDBSCAN_CROPS]])[:, None].astype(np.float32)
            target = np.stack([np.load(f)[:HDBSCAN_CROP[0], :HDBSCAN_CROP[1]] for f in label_files[:HDBSCAN_CROPS]])
            with torch.no_grad():
                embeddings = spoco(torch.from_numpy(images).cuda()).float().cpu().numpy()
            torch.cuda.synchronize()
            metric = HDBScanRandMetric(**HDBSCAN_METRIC)
            t = time.perf_counter()
            score = metric(embeddings, target[:, None].astype(np.float32))
            seconds = time.perf_counter() - t
            points = embeddings[0].reshape(embeddings.shape[1], -1).T
            t = time.perf_counter()
            one_thread = native.hdbscan(points, HDBSCAN_METRIC["min_size"], HDBSCAN_METRIC["eps"], threads=1)
            one_thread_s = time.perf_counter() - t
            threads = torch.get_num_threads()
            if not 0.0 <= score <= 1.0 or not np.array_equal(
                    one_thread, native.hdbscan(points, HDBSCAN_METRIC["min_size"], HDBSCAN_METRIC["eps"])):
                raise AssertionError(f"24c: Rand error {score}, or labels that change with the thread count")
            stats["24c metric"] = {"points": int(points.shape[0]), "dims": int(points.shape[1]), "crops": HDBSCAN_CROPS,
                                   "adapted_rand_error": float(score), "s_per_crop": seconds / HDBSCAN_CROPS,
                                   "threads": threads, "one_thread_s": one_thread_s,
                                   "clusters": int(one_thread.max() + 1), "noise": int((one_thread < 0).sum())}
            log(f"24c HDBScanRandMetric({HDBSCAN_METRIC}) on the SPOCO recipe's embeddings of {HDBSCAN_CROPS} DSB "
                f"crops {HDBSCAN_CROP} ({points.shape[0]} points of {points.shape[1]} dimensions each): adapted Rand "
                f"error {score:.4f}, {seconds / HDBSCAN_CROPS:.2f} s per crop on {threads} threads, "
                f"{one_thread_s:.2f} s on one (labels equal); {stats['24c metric']['clusters']} clusters, "
                f"{stats['24c metric']['noise']} noise points")
            del spoco
    finally:
        for name in blocked:
            del sys.modules[name]
    torch.cuda.synchronize()
    launches = (inorm.instance_norm.launches, inorm.instance_norm_backward.launches)
    if not (launches[0] > 0 and launches[1] > 0):
        raise AssertionError(f"24: norm kernel launches {launches}")
    stats["seconds"] = time.perf_counter() - t_phase
    log(f"phase 24: {stats['seconds']:.1f} s; norm launches forward {launches[0]}, backward {launches[1]}; "
        f"{json.dumps(stats)}")
    torch.cuda.empty_cache()
    return launches


def phase_zoo_conversions(port, inorm):
    """The zoo's conversions with no optional package (25a-c in the module docstring), with pydicom, nibabel, imageio,
    pycocotools, geopandas, rasterio and shapely blocked; returns the kernels' launches of its two training runs."""
    import importlib.util
    import zipfile

    from torch_em_tpu_torch.data.datasets import (get_hest_data, get_ircadb_loader, get_ircadb_paths,
                                                  get_parhyale_regen_paths, get_puma_loader, get_puma_paths,
                                                  get_uro_cell_paths)
    from torch_em_tpu_torch.data.datasets.histopathology import hest as hest_module
    from torch_em_tpu_torch.data.datasets.light_microscopy import orgline
    from torch_em_tpu_torch.transforms import BoundaryTransform
    from torch_em_tpu_torch.transforms.label import labels_to_binary
    from torch_em_tpu_torch.utils import dicom, hdf5, io, medical_io

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    import torch_conversion_layouts as layouts

    installed = [name for name in CONV_BLOCKED if importlib.util.find_spec(name) is not None]
    blocked = [name for name in CONV_BLOCKED if name not in sys.modules]
    for name in blocked:
        sys.modules[name] = None  # an import of it raises
    t_phase = time.perf_counter()
    stats = {}
    launches = [0, 0]
    try:
        log(f"25: installed here of {', '.join(CONV_BLOCKED)}: {installed or 'none'}; blocked for the phase: {blocked}")
        with tempfile.TemporaryDirectory() as tmp:
            # 25a: 3D-IRCADb's DICOM series, converted by get_ircadb_loader, into UNet3d
            t = time.perf_counter()
            roots = {split: os.path.join(tmp, "ircadb", split) for split in ("train", "val")}
            names = [f"3Dircadb1.{k + 1}" for k in range(sum(CONV_IRCADB_PATIENTS))]
            syntaxes = [(dicom.EXPLICIT_VR_LITTLE_ENDIAN, dicom.DEFLATED_EXPLICIT_VR_LITTLE_ENDIAN),
                        (dicom.IMPLICIT_VR_LITTLE_ENDIAN, dicom.IMPLICIT_VR_LITTLE_ENDIAN),
                        (dicom.RLE_LOSSLESS, dicom.RLE_LOSSLESS)]
            n_train = CONV_IRCADB_PATIENTS[0]
            written = {"train": layouts.ircadb_layout(roots["train"], names[:n_train], syntaxes[:n_train], 0,
                                                      CONV_CT_SHAPE),
                       "val": layouts.ircadb_layout(roots["val"], names[n_train:], syntaxes[n_train:], 1,
                                                    CONV_CT_SHAPE)}
            stats["a_write_s"] = time.perf_counter() - t
            sizes = {split: os.path.getsize(os.path.join(root, "ircadb.zip")) for split, root in roots.items()}
            log(f"25a data: {sum(CONV_IRCADB_PATIENTS)} patients of {CONV_CT_SHAPE} int16 CT (BitsStored 12) and uint8 "
                f"liver masks, one DICOM file a slice ({2 * sum(CONV_IRCADB_PATIENTS) * CONV_CT_SHAPE[0]} files, "
                f"{sum(sizes.values()) / 2 ** 20:.1f} MiB in two archives), in {stats['a_write_s']:.2f} s; syntaxes "
                f"(CT, mask) {syntaxes}")
            t = time.perf_counter()
            paths = {split: get_ircadb_paths(root) for split, root in roots.items()}
            stats["a_convert_s_per_volume"] = (time.perf_counter() - t) / sum(CONV_IRCADB_PATIENTS)
            for split, patients in written.items():
                sample = os.path.join(roots[split], "Dataset", patients[0][0], "PATIENT_DICOM", "image_0")
                ds = dicom.dcmread(sample)
                header = (ds.Rows, ds.Columns, ds.BitsAllocated, ds.BitsStored, ds.PixelRepresentation)
                if header != (512, 512, 16, 12, 1):
                    raise AssertionError(f"25a: {sample} reads as {ds.Rows}x{ds.Columns}, {ds.BitsAllocated} bits")
                for (name, raw, mask), path in zip(patients, paths[split]):
                    with hdf5.File(path, "r") as f:
                        got_raw, got_mask = f["raw"][:], f["labels/liver"][:]
                    if os.path.basename(path) != f"{name}.h5" or got_raw.dtype != np.int16 or \
                            got_mask.dtype != np.uint8 or not np.array_equal(got_raw, raw) or \
                            not np.array_equal(got_mask, mask):
                        raise AssertionError(f"25a: the converted {path} is not the series written")
            # the RLE decode alone, on the val patient's CT series (its files are left unpacked by the reader)
            rle_dir = os.path.join(roots["val"], "Dataset", names[-1], "PATIENT_DICOM")
            t = time.perf_counter()
            for k in range(CONV_CT_SHAPE[0]):
                dicom.dcmread(os.path.join(rle_dir, f"image_{k}")).pixel_array
            stats["a_rle_read_ms_per_slice"] = (time.perf_counter() - t) / CONV_CT_SHAPE[0] * 1e3
            log(f"25a: get_ircadb_paths unpacked and converted {sum(CONV_IRCADB_PATIENTS)} patients in "
                f"{stats['a_convert_s_per_volume']:.2f} s a volume (CT and mask series to gzip h5); each h5 equals the "
                f"series written; an RLE Lossless slice reads in {stats['a_rle_read_ms_per_slice']:.2f} ms")
            del written

            def ircadb_loader(split, shuffle, n_samples):
                return get_ircadb_loader(roots[split], CONV_IRCADB_PATCH, MED_BATCH, organ="liver",
                                         label_transform=labels_to_binary, num_workers=LOADER_THREADS,
                                         shuffle=shuffle, n_samples=n_samples)

            train, val = ircadb_loader("train", True, MED_BATCH * CONV_FIT), ircadb_loader("val", False, MED_BATCH)
            np.random.seed(9)
            model = port.UNet3d(**dict(MED_MODEL, out_channels=1), depth=MED_DEPTH, device="cuda", seed=0)
            trainer = port.default_segmentation_trainer(
                "conv-ircadb", model, train, val, learning_rate=LEARNING_RATE, device="cuda", mixed_precision=True,
                logger=LossLog, save_root=tmp)
            t = time.perf_counter()
            resumed, fit_launches = fit_and_resume(port, inorm, trainer, CONV_FIT, CONV_RESUME, len(val),
                                                   "25a IRCADb UNet3d", falling=False)
            stats["a_fit_s"] = time.perf_counter() - t
            launches = [launches[0] + fit_launches[0], launches[1] + fit_launches[1]]
            timed = MED_BATCH * (LOADER_THREADS + LM_LOADER_STEPS)
            stats["a_loader_thread_patches_per_s"] = loader_rate(resumed, ircadb_loader("train", True, timed),
                                                                 steps=LM_LOADER_STEPS, warmup=LOADER_THREADS)
            x, y = bare_step(resumed, ircadb_loader("train", False, MED_BATCH), "25a UNet3d f=32 CT")
            stats["a_step_ms"] = time_ms(resumed._train_step, x, y, iters=10, repeats=1)
            log(f"25a loader, {LOADER_THREADS} thread workers over the gzip h5 volumes, feeding steps: "
                f"{stats['a_loader_thread_patches_per_s']:.2f} patches/s; the bare step {stats['a_step_ms']:.2f} ms, "
                f"{MED_BATCH * 1e3 / stats['a_step_ms']:.2f} patches/s; {nvidia_smi()}")
            del trainer, resumed, model, train, val, x, y
            torch.cuda.empty_cache()

            # 25b: PUMA's GeoJSON nuclei, rasterized on first use, into UNet2d at DSB width
            puma_root = os.path.join(tmp, "puma")
            t = time.perf_counter()
            rois = layouts.puma_layout(puma_root, CONV_PUMA_ROIS, CONV_PUMA_NUCLEI)
            stats["b_write_s"] = time.perf_counter() - t
            t = time.perf_counter()
            puma_paths = get_puma_paths(puma_root, "train", "nuclei")
            stats["b_convert_s_per_roi"] = (time.perf_counter() - t) / len(rois)
            if sorted(os.path.basename(p) for p in puma_paths) != sorted(f"{n}.h5" for n in rois):
                raise AssertionError(f"25b: converted {puma_paths}")
            t = time.perf_counter()
            for path in puma_paths:
                rgb, nuclei, classes = rois[os.path.basename(path)[:-3]]
                instances, semantic = layouts.puma_reference(nuclei, classes)
                with hdf5.File(path, "r") as f:
                    got = f["raw"][:], f["labels/instances/nuclei"][:], f["labels/semantic/nuclei"][:]
                if not np.array_equal(got[0], rgb.transpose(2, 0, 1)):
                    raise AssertionError(f"25b: the raw of {path} is not the ROI written")
                for label, g, e in (("instance", got[1], instances), ("semantic", got[2], semantic)):
                    if g.dtype != e.dtype or not np.array_equal(g, e):
                        raise AssertionError(f"25b: the {label} mask of {path} differs from the brute-force pixel-"
                                             f"centre reference at {int((g != e).sum())} pixels")
                if len(np.unique(got[1])) - 1 != len(nuclei):
                    raise AssertionError(f"25b: {len(np.unique(got[1])) - 1} instances of {len(nuclei)} nuclei")
            stats["b_reference_s"] = time.perf_counter() - t
            n_parts = sum(len(parts) > 1 for _, nuclei, _ in rois.values() for parts in nuclei)
            n_holes = sum(len(parts[0]) > 1 for _, nuclei, _ in rois.values() for parts in nuclei)
            log(f"25b: {len(rois)} PUMA ROIs of 1024x1024 with {CONV_PUMA_NUCLEI} GeoJSON nuclei each ({n_holes} "
                f"with a hole, {n_parts} MultiPolygons in all) written in {stats['b_write_s']:.2f} s, converted in "
                f"{stats['b_convert_s_per_roi']:.2f} s a ROI; instance and semantic masks equal to the brute-force "
                f"pixel-centre even-odd reference ({stats['b_reference_s']:.2f} s)")

            def puma_loader(shuffle, n_samples):
                return get_puma_loader(puma_root, DSB_BATCH, HP_PATCH, "train", annotations="nuclei",
                                       label_transform=BoundaryTransform(add_binary_target=True),
                                       num_workers=LOADER_THREADS, shuffle=shuffle, n_samples=n_samples)

            train, val = puma_loader(True, DSB_BATCH * CONV_FIT), puma_loader(False, DSB_BATCH)
            np.random.seed(10)
            model = port.UNet2d(**HP_MODEL, depth=DSB_DEPTH, device="cuda", seed=0)
            trainer = port.default_segmentation_trainer(
                "conv-puma", model, train, val, learning_rate=LEARNING_RATE, device="cuda", mixed_precision=True,
                logger=LossLog, save_root=tmp)
            t = time.perf_counter()
            resumed, fit_launches = fit_and_resume(port, inorm, trainer, CONV_FIT, CONV_RESUME, len(val),
                                                   "25b PUMA UNet2d", falling=False)
            stats["b_fit_s"] = time.perf_counter() - t
            launches = [launches[0] + fit_launches[0], launches[1] + fit_launches[1]]
            del trainer, resumed, model, train, val
            torch.cuda.empty_cache()

            # 25c: the other conversions, each held against what was written
            t = time.perf_counter()
            org_root = os.path.join(tmp, "orgline", "data2")
            organs = layouts.orgline_layout(org_root, CONV_ORGLINE_IMAGES, CONV_ORGLINE_SHAPE)
            orgline._prepare_data(org_root, "stomach")
            n_annotations = 0
            for organ, images in organs.items():
                converted = {os.path.basename(p)[:-3]: p
                             for p in glob.glob(os.path.join(org_root, organ, "*", "*.h5"))}
                if sorted(converted) != sorted(images):
                    raise AssertionError(f"25c OrgLine: {organ} converted {sorted(converted)}")
                for name, (image, expected) in images.items():
                    with hdf5.File(converted[name], "r") as f:
                        got_image, got_masks = f["image"][:], f["masks"][:]
                    if not np.array_equal(got_image, image) or got_masks.dtype != np.uint16 or \
                            not np.array_equal(got_masks, expected):
                        raise AssertionError(f"25c OrgLine: {converted[name]} differs from the organoids written")
                    n_annotations += int(expected.max())
            stats["c_orgline_s"] = time.perf_counter() - t
            log(f"25c OrgLine: {sum(map(len, organs.values()))} stomach and breast images, {n_annotations} organoids "
                f"as compressed RLE and polygons, converted by the reader's COCO path to the masks written "
                f"({stats['c_orgline_s']:.2f} s)")

            t = time.perf_counter()
            uro_root = os.path.join(tmp, "urocell")
            os.makedirs(uro_root)
            rng = np.random.default_rng(3)
            volumes = {}
            with zipfile.ZipFile(os.path.join(uro_root, "uro_cell.zip"), "w") as zf:
                for name in ("fib1-0-0-0.nii.gz", "fib1-1-0-3.nii.gz"):
                    raw = rng.integers(0, 256, CONV_URO_SHAPE, dtype=np.uint8)
                    mito = rng.integers(0, 9, CONV_URO_SHAPE).astype(np.uint16)
                    for sub, array in (("data", raw), ("mito/instance", mito)):
                        medical_io.save_nifti(os.path.join(tmp, name), array)
                        zf.write(os.path.join(tmp, name), f"UroCell-master/{sub}/{name}")
                    volumes[name.replace("nii.gz", "h5")] = (raw, mito)
            uro_paths = get_uro_cell_paths(uro_root, "mito")
            for path in uro_paths:
                raw, mito = volumes[os.path.basename(path)]
                with hdf5.File(path, "r") as f:
                    got_raw, got_mito = f["raw"][:], f["labels/mito"][:]
                if got_raw.dtype != np.float64 or not np.array_equal(got_raw, raw.astype(np.float64)) or \
                        got_mito.dtype != np.uint32 or not np.array_equal(got_mito, mito.astype(np.uint32)):
                    raise AssertionError(f"25c UroCell: {path} is not the NIfTI volumes written")
            if len(uro_paths) != len(volumes):
                raise AssertionError(f"25c UroCell: {uro_paths}")
            stats["c_urocell_s"] = time.perf_counter() - t

            t = time.perf_counter()
            rng = np.random.default_rng(4)
            images = {"u8.png": rng.integers(0, 256, (96, 80), dtype=np.uint8),
                      "u16.png": rng.integers(0, 2 ** 16, (96, 80), dtype=np.uint16),
                      "rgb.png": rng.integers(0, 256, (96, 80, 3), dtype=np.uint8),
                      "rgba.tif": rng.integers(0, 256, (96, 80, 4), dtype=np.uint8),
                      "i32.tif": rng.integers(-2 ** 31, 2 ** 31, (96, 80), dtype=np.int32),
                      "f32.tif": rng.standard_normal((96, 80), dtype=np.float32),
                      "stack_u16.tif": rng.integers(0, 2 ** 16, (12, 96, 80), dtype=np.uint16),
                      "stack_f32.tif": rng.standard_normal((5, 96, 80), dtype=np.float32)}
            for name, array in images.items():
                io.write_data(os.path.join(tmp, name), None, array)
                got = io.load_image(os.path.join(tmp, name))
                if got.dtype != array.dtype or not np.array_equal(got, array):
                    raise AssertionError(f"25c write_data: {name} reads back as {got.shape} {got.dtype}")
            stats["c_write_data_s"] = time.perf_counter() - t

            t = time.perf_counter()
            par_root = os.path.join(tmp, "parhyale")
            os.makedirs(os.path.join(par_root, "data"))
            rng = np.random.default_rng(5)
            hyperstack = rng.integers(0, 2 ** 16, (50,) + CONV_PARHYALE_STACK, dtype=np.uint16)
            io.write_data(os.path.join(par_root, "data", "Parhyale_H2B-EGFP_images_tp01-50.tif"), None,
                          hyperstack.reshape((-1,) + CONV_PARHYALE_STACK[1:]))
            tps = [0, 10, 20, 30, 40, 49]
            labels_tp = {}
            for tp in tps:
                labels_tp[tp] = rng.integers(0, 40, CONV_PARHYALE_STACK, dtype=np.uint16)
                name = f"Parhyale_instance-segmentation-labels_tp{tp + 1:02d}.tif"
                io.write_data(os.path.join(par_root, "data", name), None, labels_tp[tp])
            par_paths = get_parhyale_regen_paths(par_root)
            if [os.path.basename(p) for p in par_paths] != [f"Parhyale_H2B-EGFP_{tp + 1}.h5" for tp in tps]:
                raise AssertionError(f"25c Parhyale: {par_paths}")
            for tp, path in zip(tps, par_paths):
                with hdf5.File(path, "r") as f:
                    if not np.array_equal(f["raw"][:], hyperstack[tp]) or not np.array_equal(f["labels"][:],
                                                                                            labels_tp[tp]):
                        raise AssertionError(f"25c Parhyale: {path} is not time point {tp} written")
            stats["c_parhyale_s"] = time.perf_counter() - t

            t = time.perf_counter()
            hest_root = os.path.join(tmp, "hest")
            slides = layouts.hest_layout(hest_root, CONV_HEST_NUCLEI)
            get_hest_data(hest_root)
            n_nuclei = 0
            for sid, (coords, scale, cellvit, xenium) in slides.items():
                with hdf5.File(os.path.join(hest_root, "preprocessed", f"{sid}.h5"), "r") as f:
                    got = f[hest_module.LABEL_KEYS["instances"]][:], f[hest_module.LABEL_KEYS["xenium_instances"]][:]
                for i, coord in enumerate(coords):
                    for label, nuclei, mask in (("CellViT", cellvit, got[0][i]), ("Xenium", xenium, got[1][i])):
                        expected = layouts.hest_reference(nuclei, coord, 224, scale)
                        if not np.array_equal(mask, expected):
                            raise AssertionError(f"25c HEST: {sid} patch {i} {label} nuclei differ from the reference "
                                                 f"at {int((mask != expected).sum())} pixels")
                        n_nuclei += int(expected.max())
            stats["c_hest_s"] = time.perf_counter() - t
            log(f"25c: UroCell's NIfTI volumes to float64 h5 ({stats['c_urocell_s']:.2f} s), write_data's PNG and TIFF "
                f"round trips, multi-page stacks included ({stats['c_write_data_s']:.2f} s), Parhyale's hyperstack of "
                f"{50 * CONV_PARHYALE_STACK[0]} pages ({stats['c_parhyale_s']:.2f} s) and HEST's CellViT GeoJSON and "
                f"Xenium WKB nuclei at 0.5 and 0.25 um/px, {n_nuclei} window selections ({stats['c_hest_s']:.2f} s): "
                "each equal to what was written")
    finally:
        for name in blocked:
            del sys.modules[name]
    stats["norm_launches"] = launches
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"zoo conversions: {json.dumps(stats)}; {nvidia_smi()}")
    torch.cuda.empty_cache()
    return tuple(launches)


def time_host_ms(fn, *args, repeats=5):
    """Median host time of ``fn(*args)`` in ms."""
    times = []
    for _ in range(repeats):
        t = time.perf_counter()
        fn(*args)
        times.append(time.perf_counter() - t)
    return float(np.median(times)) * 1e3


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree, key=str) for leaf in _tree_leaves(tree[key])]
    return [tree]


PHASE_TITLES = {
    8: "AugmentationPipeline.apply_batched on the card against the CPU",
    9: "the DSB recipe, UNet2d at DSB width, and the CLI",
    10: "the SNEMI recipe, affinities and the mutex watershed",
    11: "the SPOCO recipe, embeddings, the EMA network and the grid search; the other norms",
    12: "the ViM-UNet / UNETR recipe, UNETR vit_b and ViM-UNet vim_t at 512x512; UNETR3D",
    13: "self-training at DSB width: MeanTeacher, FixMatch, UniMatch v2, the Probabilistic U-Net, FlashOptim",
    14: "the other encoder families in UNETR (SAM2, DINOv2, DINOv3, MAE, ScaleMAE, SAM3) and the 3-D ResNet "
        "classification",
    15: "the multi-device paths: train_multi_gpu over NCCL, two processes on the card over gloo (data-parallel step, "
        "halo-sharded serving, the spatially sharded step), two replicas in predict_with_halo",
    16: "Shallow2Deep with no sklearn: the forest fixtures, the committed forests' recipe and the advanced path "
        "fitted natively, the enhancer on the recipe's forests' predictions, the bioimage.io export, validation, "
        "import and torchscript, Shallow2DeepModel on the test images; NIfTI and MetaImage",
    17: "the dataset zoo's EM readers: get_benchmark_loader over TIFF volumes at MitoLab benchmark 5's published shape "
        "into the tracked model, get_mitolab_loader into UNet2d",
    18: "the dataset zoo's light-microscopy readers: get_dsb_loader on dsb2018's layout into the DSB recipe's UNet2d "
        "(and the SPOCO recipe's loader), get_livecell_loader on LIVECell's COCO layout into UNETR",
    19: "the dataset zoo's histopathology and medical readers: get_monuseg_loader on MoNuSeg's XML layout into UNet2d "
        "at DSB width, get_amos_loader on AMOS' CT NIfTI volumes into UNet3d",
    20: "the quality probes' paths: the DSB probe (UNet2d f=16, 128x128), the tracked DSB (f=64, 256x256) and the "
        "tracked CREMI model through scripts/torch_parity2d.py and torch_parity3d.py; the SPOCO and SNEMI probes "
        "through scripts/torch_spoco2d.py and torch_parity3d.py, deterministic",
    21: "ConvBlock2d, ConvBlock3d, Upsampler2d and Upsampler3d against their dim forms; ops.native.is_available(); "
        "the classification scores in numpy against sklearn's recorded values",
    24: "training logs with the default loggers and HDBSCAN, with no tensorboardX, tensorboard, sklearn or "
        "matplotlib: the tracked model's TensorBoard events read back, SPOCO, MeanTeacher and classification with "
        "their loggers, the sklearn fixtures, HDBScanRandMetric on SPOCO embeddings",
    25: "the zoo's conversions with no pydicom, nibabel, imageio, pycocotools, geopandas, rasterio or shapely: "
        "3D-IRCADb's DICOM series into UNet3d, PUMA's GeoJSON nuclei into UNet2d; OrgLine's COCO masks, UroCell's "
        "NIfTI, write_data's images, Parhyale's hyperstack, HEST's CellViT and Xenium nuclei",
}
# the phases of the fan-out that launch the norm kernels, by the name of their path in the launches line
FANOUT_NAMES = {9: "DSB", 10: "SNEMI", 11: "SPOCO", 12: "UNETR and ViM-UNet", 13: "self-training",
                14: "encoder families", 15: "multi-device", 16: "Shallow2Deep", 17: "EM zoo", 18: "LM zoo",
                19: "histopathology and medical zoo", 20: "quality probes", 24: "training logs",
                25: "zoo conversions"}


def run_phases(numbers):
    """Run phases ``numbers`` (of 8 to 21, 24 and 25) in order in this process; returns {phase: [forward,
    backward]}, the norm kernels' launches of each."""
    import torch_em_tpu_torch as port
    import torch_em_tpu_torch.models.unet as unet_module
    import torch_em_tpu_torch.ops.device as device_ops
    import torch_em_tpu_torch.ops.instance_norm as inorm

    launches, livecell = {}, None
    with tempfile.TemporaryDirectory() as livecell_dir:
        for number in numbers:
            log(f"phase {number}: {PHASE_TITLES[number]}")
            if number in (12, 14) and livecell is None:
                # phases 12 and 14 train on the same LIVECell-sized images
                livecell = livecell_images(livecell_dir)
                log(f"LIVECell-sized data: {len(livecell[0])} images {np.load(livecell[0][0]).shape}")
            got = (0, 0)
            if number == 8:
                phase_apply_batched(port)
            elif number == 9:
                got = phase_dsb(port, inorm)
            elif number == 10:
                got = phase_snemi(port, inorm, device_ops)
            elif number == 11:
                got = phase_spoco(port, inorm)
                phase_norm_variants(port)
            elif number == 12:
                got = phase_vit_recipes(port, inorm, *livecell)
            elif number == 13:
                got = phase_self_training(port, inorm)
            elif number == 14:
                got = phase_encoder_families(port, inorm, *livecell)
            elif number == 15:
                got = phase_multi_device(port, inorm, device_ops)
            elif number == 16:
                got = phase_shallow2deep(port, inorm)
            elif number == 17:
                got = phase_em_zoo(port, inorm)
            elif number == 18:
                got = phase_lm_zoo(port, inorm)
            elif number == 19:
                got = phase_hp_med_zoo(port, inorm)
            elif number == 20:
                got = phase_quality_probes(port, inorm)
            elif number == 21:
                phase_public_names(unet_module, inorm)
            elif number == 24:
                got = phase_logs_hdbscan(port, inorm, device_ops)
            elif number == 25:
                got = phase_zoo_conversions(port, inorm)
            else:
                raise ValueError(f"no phase {number} among 8 to 21, 24 and 25")
            launches[number] = [int(got[0]), int(got[1])]
            # the next phase, and the other groups, get the card memory this one held
            torch.cuda.empty_cache()
    return launches


def run_fanout(groups):
    """Run each group of phases in a child process of its own, all groups at once on the card, each with
    ``OMP_NUM_THREADS`` set to its share of the host's cores; print the children's lines, group by group, when all
    have ended. A group that fails, or that has not ended ``FANOUT_DEADLINE`` s after the run's start, stops the
    others (with every process they started) and raises, naming each group that did not end well by its exit
    code, or as "(stopped)" where this process stopped it. Returns {phase: [forward, backward]} launches."""
    threads = max(1, (os.cpu_count() or len(groups)) // len(groups))
    env = dict(os.environ, OMP_NUM_THREADS=str(threads),
               CHIP_SMOKE_T0=repr(time.time() - (time.perf_counter() - T0)))
    children = []
    # a stop of this process (SIGTERM) stops the children too
    old_handler = signal.signal(signal.SIGTERM, lambda *_: sys.exit(128 + signal.SIGTERM))
    try:
        for group in groups:
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
            children.append((group, out, err, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--phases", ",".join(map(str, group))],
                stdout=out, stderr=err, env=env, text=True, start_new_session=True)))
        while any(child.poll() is None for *_, child in children):
            if any(child.returncode for *_, child in children):
                break
            if time.perf_counter() - T0 > FANOUT_DEADLINE:
                break
            time.sleep(1)
    finally:
        # the children still running when the first failed or the deadline passed are stopped here
        stopped = {child.pid for *_, child in children if child.poll() is None}
        for *_, child in children:
            # each child leads a process group of its own, with the processes it started
            with contextlib.suppress(ProcessLookupError):
                os.killpg(child.pid, signal.SIGKILL)
            child.wait()
        signal.signal(signal.SIGTERM, old_handler)
    launches, failed = {}, []
    for group, out, err, child in children:
        out.seek(0)
        err.seek(0)
        lines = out.read().splitlines()
        sys.stderr.write(err.read())
        sys.stderr.flush()
        result = lines.pop() if child.returncode == 0 and lines else None
        print("\n".join(lines), flush=True)
        if result is None:
            ended = "stopped" if child.pid in stopped and child.returncode == -signal.SIGKILL else \
                f"exit {child.returncode}"
            failed.append(f"phases {group} ({ended})")
        else:
            launches.update({int(k): v for k, v in json.loads(result)["launches"].items()})
    if failed:
        raise RuntimeError(f"the fan-out's groups failed or were stopped: {', '.join(failed)}")
    return launches


def child_main(numbers):
    """A group of the fan-out: its phases' lines, then ``{"launches": {...}}`` as the last line."""
    # end with the process that started this one
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr, flush=True)
        return 2
    try:
        launches = run_phases(numbers)
    except Exception:
        traceback.print_exc()
        log(f"FAILED in phases {numbers}")
        return 1
    print(json.dumps({"launches": launches}), flush=True)
    return 0


def main():
    log("start")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this run needs one NVIDIA card",
              file=sys.stderr, flush=True)
        return 2
    try:
        import torch_em_tpu_torch as port
        import torch_em_tpu_torch.models.unet as unet_module
        import torch_em_tpu_torch.ops.device as device_ops
        import torch_em_tpu_torch.ops.instance_norm as inorm

        log("phase 1: device")
        smi = nvidia_smi()
        name = torch.cuda.get_device_name(0)
        log(f"nvidia-smi: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.device_count()} device(s), device 0 {name}")

        log("phase 2: build kernels")
        t = time.perf_counter()
        with ThreadPoolExecutor(max_workers=2) as pool:
            builds = [pool.submit(inorm.load_kernel), pool.submit(inorm.load_backward_kernel)]
            for build in builds:
                build.result()
        log(f"built instance_norm.cu and instance_norm_bwd.cu in {time.perf_counter() - t:.1f} s")

        log("phase 3: forward kernel against its plain version, serving and training shapes")

        def tracked_shapes(block, halo=(0, 0, 0)):
            block = tuple(b + 2 * h for b, h in zip(block, halo))
            return norm_shapes(block, TRACKED["scale_factors"],
                               widths(TRACKED["initial_features"], len(TRACKED["scale_factors"])))

        shapes = tracked_shapes(BLOCK_SHAPE, HALO)
        train_shapes = tracked_shapes(TRAIN_PATCH)
        dsb_shapes = norm_shapes(DSB_PATCH[1:], [[2, 2]] * DSB_DEPTH, widths(DSB_MODEL["initial_features"], DSB_DEPTH))
        spoco_shapes = norm_shapes(DSB_PATCH[1:], [[2, 2]] * SPOCO_DEPTH,
                                   widths(SPOCO_MODEL["initial_features"], SPOCO_DEPTH))
        # the self-training steps (phase 13): UniMatch v2's student takes both strong views of a DSB batch
        # at once, the Probabilistic U-Net's U-Net has the widths 32/64/128/192 and a base of 384
        st_shapes = {"unimatch": (2 * DSB_BATCH, dsb_shapes),
                     "punet": (DSB_BATCH, norm_shapes(DSB_PATCH[1:], [[2, 2]] * len(PUNET_FILTERS), PUNET_FILTERS)),
                     # and the MitoLab recipe's UNet2d at DSB width on 224x224 patches (phase 17)
                     "mitolab": (EM_2D_BATCH, norm_shapes(EM_2D_PATCH, [[2, 2]] * DSB_DEPTH,
                                                          widths(EM_2D_MODEL["initial_features"], DSB_DEPTH))),
                     # and the last validation batch of the DSB recipe's 50 test images (phase 18)
                     "dsb_test_tail": (LM_DSB_IMAGES[1] % DSB_BATCH, dsb_shapes),
                     # and phase 19's steps: UNet2d at DSB width on 512x512 H&E patches from 3 channels, UNet3d f=32
                     # on (128, 128, 64) CT patches with isotropic pooling
                     "monuseg": (DSB_BATCH, norm_shapes(HP_PATCH, [[2, 2]] * DSB_DEPTH,
                                                        widths(HP_MODEL["initial_features"], DSB_DEPTH),
                                                        in_channels=HP_MODEL["in_channels"])),
                     "amos": (MED_BATCH, norm_shapes(MED_PATCH, [[2, 2, 2]] * MED_DEPTH,
                                                     widths(MED_MODEL["initial_features"], MED_DEPTH))),
                     # and phase 25a's: the same UNet3d on (64, 128, 128) patches of the converted IRCADb volumes
                     # (25b's UNet2d on PUMA takes 19a's rows)
                     "ircadb": (MED_BATCH, norm_shapes(CONV_IRCADB_PATCH, [[2, 2, 2]] * MED_DEPTH,
                                                       widths(MED_MODEL["initial_features"], MED_DEPTH))),
                     # and phase 20's DSB probe: UNet2d f=16 at batch 4 of 128x128, its validation and scoring
                     # batches too
                     "dsb_probe": (DSB_PROBE_BATCH, norm_shapes(DSB_PROBE_PATCH, [[2, 2]] * DSB_DEPTH,
                                                                widths(DSB_PROBE_FEATURES, DSB_DEPTH))),
                     # and phase 20e's SNEMI probe: AnisotropicUNet f=8 at batch 1 of 8x64x64 (its validation and
                     # scoring forwards take the same rows)
                     "snemi_probe": (1, norm_shapes(SNEMI_PROBE_PATCH, SNEMI_PROBE_SCALES,
                                                    widths(SNEMI_PROBE_FEATURES, len(SNEMI_PROBE_SCALES))))}
        # the SNEMI recipe's model differs from the tracked one only after its last norm
        snemi_shapes = {"snemi_serving": tracked_shapes(SNEMI_BLOCK, HALO),
                        "snemi_validation": tracked_shapes(SNEMI_VALIDATE_BLOCK, HALO)}
        assert all(len(s) == NORMS_PER_FORWARD for s in (shapes, train_shapes, dsb_shapes, spoco_shapes,
                                                         *snemi_shapes.values(),
                                                         *(s for k, (_, s) in st_shapes.items() if k != "snemi_probe")))
        assert len(st_shapes["snemi_probe"][1]) == SNEMI_PROBE_NORMS
        # the recipe's UNETR (vit_b, skip connections) and ViM-UNet (vim_t) decoders at 512x512
        vit_shapes = {"unetr": (VIT_BATCH, unetr_norm_shapes(768, True)),
                      "vimunet": (VIT_BATCH, unetr_norm_shapes(192, False)),
                      # the encoder families' decoders (phase 14), at their training batch
                      **{name: (batch, family_norm_shapes(kwargs, channels, grid))
                         for name, kwargs, batch, channels, grid in FAMILY_RECIPES}}
        # the sharded paths (phase 15): a rank's slab with the derived halo of 36 planes on either side, 64 planes
        # at 512x512 served by halo_sharded_predict, 48 at 256x256 trained by spatial_sharded_train_step
        sharded_shapes = {"halo_serving": tracked_shapes((MD_HALO_VOLUME[0] // MD_PROCESSES,) + MD_HALO_VOLUME[1:],
                                                         (36, 0, 0)),
                          "spatial_training": tracked_shapes((MD_SPATIAL_PATCH[0] // MD_PROCESSES,)
                                                             + MD_SPATIAL_PATCH[1:], (36, 0, 0))}
        # Shallow2DeepModel's enhancer (phase 16) on two 512x512 images in float32
        predict_shapes = {"s2d_predict": (S2D_PREDICT[0], norm_shapes(S2D_PREDICT[1], [[2, 2]] * S2D_DEPTH,
                                                                      widths(S2D_MODEL["initial_features"],
                                                                             S2D_DEPTH))),
                          # and the tracked DSB's scoring forwards in phase 20 (and its validation batch there)
                          "dsb_score": (QP_EVAL_BATCH, dsb_shapes)}
        forward = phase_norm_kernel(inorm, shapes, train_shapes, dsb_shapes, snemi_shapes, spoco_shapes, vit_shapes,
                                    st_shapes, sharded_shapes, predict_shapes)

        log("phase 4: serving path, tiled AnisotropicUNet inference")
        serving_launches = phase_main_path(port, inorm, unet_module)

        log("phase 5: backward kernel against its plain version, training and serving shapes")
        backward, forward["training"], forward["dsb_training"], forward["spoco_training"], recipe_step_fwd, \
            spatial_level0 = phase_backward_kernel(inorm, train_shapes, shapes, dsb_shapes, spoco_shapes, vit_shapes,
                                                   st_shapes, sharded_shapes["spatial_training"])
        forward.update(recipe_step_fwd)
        forward["sharded_level0"].update({f"{k} (training)": v for k, v in spatial_level0.items()})

        log("phase 6: training path, default_segmentation_trainer on the tracked model")
        train_fwd, train_bwd = phase_training(port, inorm, device_ops)

        log("phase 7: the 3-D recipe through default_segmentation_loader")
        recipe_fwd, recipe_bwd = phase_factory_3d(port, inorm, device_ops)

        # phase 22 runs here, alone on the card: its loader rates stand beside phase 7's
        log("phase 22: HDF5 with no h5py: bench.py's loader volume written and read by the port, the tracked model "
            "trained from its h5 SegmentationDataset, the 12 tracked parity h5 files, LZF through the native build")
        h5_fwd, h5_bwd = phase_hdf5(port, inorm)

        # phase 23 runs here too, alone on the card: its loader rates stand beside phases 7 and 22
        log("phase 23: zarr and N5 with no tensorstore: the loader volume written and read by the port, the tracked "
            "model trained from zarr and fed from N5 by process workers, the tensorstore fixtures, the CLI's "
            "prediction to N5, the platynereis (N5) and TissueNet (zarr) readers")
        zn_fwd, zn_bwd = phase_zarr_n5(port, inorm)

        fanout = run_phases([15])
        log(f"phases 8 to 21 but 15, 24 and 25, in {len(FANOUT)} child processes at once: "
            + ", ".join("+".join(map(str, group)) for group in FANOUT))
        fanout.update(run_fanout(FANOUT))
        parts = [("serving", serving_launches, 0), ("training", train_fwd, train_bwd),
                 ("3-D recipe", recipe_fwd, recipe_bwd),
                 *((FANOUT_NAMES[n], *fanout[n]) for n in sorted(fanout) if n in FANOUT_NAMES),
                 ("HDF5", h5_fwd, h5_bwd), ("zarr and N5", zn_fwd, zn_bwd)]
        forward["launches"] = sum(f for _, f, _ in parts)
        backward["launches"] = sum(b for _, _, b in parts)
        log("forward kernel launches: " + " + ".join(f"{f} {path}" for path, f, _ in parts)
            + "; backward kernel launches: " + " + ".join(f"{b} {path}" for path, _, b in parts if path != "serving"))
    except Exception:
        traceback.print_exc()
        log("FAILED")
        return 1

    print(smi, flush=True)
    print(json.dumps({"kernels": [forward, backward]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phases"]:
        sys.exit(child_main([int(n) for n in sys.argv[2].split(",")]))
    sys.exit(main())
