#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``bbbp_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each (a failing check raises, so the script exits non-zero
before its last line):

1. environment: the card, torch and CUDA versions, TF32 off; builds both
   native libraries from the checkout's sources and prints the seconds;
2. kernel 1 (``packed_project``) against its plain version on the card
   (k = 30, 50 and 64, one column pair a lane and two; k = 31, unaligned
   pairs; k = 200 and 1001, two and eight column slices; d = 2000;
   all-ones and all-zero rows), then timed on 5%-random words and on the
   fingerprints of ``synthetic_smiles(16384, seed=1)``;
3. kernel 2 (``dense_forest_predict``, via ``raw_predict``) against its
   plain version on the card (depth 0, 1, 6, 8 and 12, F = 30 and 2048,
   T = 300 and 301; the aux forests' F = 326 with 400 trees of depth 6 and
   300 of depth 10), then timed on the z of the random words and of the
   fingerprints, and at F = 326 on 1,058 and 7,809 rows;
4. the slice: ``screen()`` on ``cuda`` with the full-width fixture model over
   65,536 + a ragged tail of ``synthetic_smiles`` and 3 invalid SMILES; both
   kernels' launch counters must move, and the first 2,048 rows must match
   ``screen(device="cpu")``; then the same over ``devices=["cuda:0",
   "cuda:0"]`` and, where torch sees more than one card, over every card:
   each CSV byte-equal to the one-card CSV, each kernel launched once a
   shard of every chunk, counted by card (``[4 cards]``);
5. the trainer's kernels (``ops/forest_train.py``: K3 ``level_histogram``,
   K4 ``best_splits``, K5 ``leaf_values``) against their plain versions on
   the card, for n = 1, 7,809 and 65,536 rows, F = 30, 167, 300 and 326
   features (and F = 1) and levels 0, 5 and 9, with zero-weight rows,
   constant features (exact ties), column masks, oblivious mode and
   min_child masking, then matrices whose features have 1, 2, 3 and 64
   occupied bins with skewed node sizes, every row in one node of level 9,
   and rows that all weigh 0: K3 bit-equal to its fixed-point plain version
   with and without ``n_bins``, within one f32 rounding of the exact
   (float64) sum and bit-identical over two runs, a wrong ``n_bins``
   refused; K4 equal to the plain version but at counted near ties (their
   largest score gap is K4's max_abs_err), also with the best feature
   masked out and with no valid split in the level; K5 at n = 1, 7,809
   and 65,536 with 1, 64 and 1,024 leaves bit-equal to its fixed-point
   plain version and within 1e-6 relative of the float64 sums, and with
   the next tree (reg and cls, subsample 1 and 0.8, weights 0 and 1) its
   g, h and bounds bit-equal to the torch ops; the routing, which has no
   launch of its own: K3 of the next level given each case's split
   (positions and the tree's pairs equal to ``route_rows_reference``, each
   node's sorted rows as a set, the histogram bit-equal to the fixed-point
   plain version on the routed rows) and K5 given a last level's split
   (bit-equal to ``route_rows_reference`` then its plain version, pos left
   as it is); then each timed at the
   training path's shapes (n = 7,809 and 65,536, F = 30, every level of
   depth 6, levels 1-5 also with the routing of the level before against
   the same call alone; K5 alone, with the next tree's gradients, and with
   them and the routing) and the transfer
   path's (n = 7,809, F = 326, levels 0, 5 and
   9; K4 also in oblivious mode; K5 with 1,024 leaves) beside its plain
   version, its bound and, for K3, ``index_add_`` (the one PyTorch call for
   the same function) and ``torch.bincount`` twice;
6. training: ``ScreeningModel.train`` on ``cuda`` at full width over the
   7,809-molecule labelled set (``testing.labelled_training_set``), with
   every trainer kernel's launch count (300 trees × 6 levels; no routing
   launch; K9 twice a tree and once before, each replay of the tree's CUDA
   graph counting its tree's launches); a second fit
   with the same seed must grow the same trees; the host's launch calls of
   one fit of its forest under ``torch.profiler`` (at most 4 a tree);
   ``GBDTClassifier
   (subsample=1)`` on the same z on ``cuda`` and ``cpu`` must grow the same
   trees up to equivalent splits and a counted near tie; training accuracy
   above the majority share; and ``screen()`` with the trained model on
   ``cuda`` against ``cpu`` on a prefix of molecules not in the training
   set, under phase 4's near-tie rule (at most 1% near-tie rows); then the
   tree as one device program: gbdt (subsample 0.8, colsample 0.6),
   oblivious and rf (depth 10) fits of 30 trees, one fit and three lanes,
   bit-equal to the eager loop (``graph=False``) with the same launches;
   a 50-tree ``GBDTClassifier(subsample=0.8, colsample=0.6)`` and a 10-tree
   ``RandomForestClassifier`` held card against CPU by the rule above (the
   keyed draws are the same on both); K9 ``forest_draws`` bit-equal to its
   plain version at L = 1, 15 and 255, every stream, and timed beside its
   plain version and its bound;
7. the similarity kernels (``ops/similarity.py``: K6 ``tanimoto_topk``,
   K7 ``tanimoto_gram``, K8 ``minmax_gram``) against their plain versions
   on the card, on the MACCS bits, Morgan bits and Morgan counts of the
   7,809 labelled molecules and of 1,058 further ones
   (``testing.regression_molecules``): the transfer path's shapes (1,058
   queries against 7,809 rows, d = 167, k = 25), a regression fold's
   (106 against 952, d = 167 and 2048, k = 10), the full grams (1,058 x
   1,058), Nq = 1, Nr = 1, k = 1, k = Nr, k = 1,024, zero rows, forced
   ties, distinct fractions equal in f32 at the k-th place (65,536 bits),
   k = 1 / 25 / 1,024 with Nr no multiple of a chunk, rows of 6 words that
   are not 16-byte aligned (``packed_bits`` pads to 4 words), IDF weights, counts
   above the clip, for K7 36 ragged shapes (Nq, Nr in 1 / 33 / 127 / 1,058,
   1 / 6 / 7 / 42 / 64 / 2,048 words) and for K8 18 (1 / 42 / 512 words).
   K6's indices equal and its similarities bit-equal, K7 and K8 bit-equal
   without weights and within 1e-5 with (weighted twice bit-identical); the
   host's launch calls of one profiled call (K6 and unweighted K7: one);
   then each timed beside its plain version, its bound (and for K6 and K7
   the former count's), and a
   library form (one ``torch.matmul`` on operands already unpacked, with
   the epilogue; for K6 followed by ``torch.topk``, which orders ties
   otherwise);
8. the transfer path: first a ``GBDTClassifier(subsample=1)`` fit of 30
   trees on ``cuda`` over the aux molecules' 326 features, audited node by
   node along its own splits against the plain arithmetic as in phase 6,
   the same for an oblivious fit of 30 trees (a level's summed gains),
   its margins through the forest kernel against the plain version, and
   K3 (bit-equal to its fixed-point plain version there too) and K4 timed
   on its own binned rows (MACCS bits fill two bins a feature) at levels 0,
   5 and 9;
   then ``transfer_features`` on ``cuda`` at full width (all
   four models, 400/400/300 trees, k = 25, holdout 0.1) with the labelled
   set as the aux data and the 1,058 molecules as the regression set: the
   launches of every kernel, the four holdout AUCs (each above 0.6), the
   wall time by stage, the ``transfer_tknn`` column within 1e-6 of a
   ``cpu`` run, and the cache file read back. Then the regression stack's
   three chemistry-kernel legs on the 1,058 molecules with a seeded target,
   10 folds (``TanimotoKNNRegressor``, ``TanimotoKernelRidge``,
   ``ChemKernelRidge``, one fold more with IDF weights, and both
   ``full_gram``s), ``cuda`` against ``cpu``: kNN within 1e-5, ridge within
   2e-3 (two f32 Cholesky solves), grams within 1e-5.

9. the regressor (``models/transformer_cnn.py``, ``train/loop.py``; no
   kernel of its own, the JAX package's model is flax layers):
   ``testing.regression_nn_inputs`` (``preprocess_regression`` on the CPU
   over the 1,058 regression molecules: MACCS + 31 descriptors, 198 wide,
   images 128 x 128 x 3; seconds, rows dropped); ``MultiModalRegressor(n_layers=4)`` forward on
   ``cuda`` against ``cpu`` from the same parameters for the three fusions
   x ``fp_tokens`` 1 and 4, and Morgan 2048 through ``fp_in_proj``, f32
   (TF32 off, cuDNN's too) within 1e-4 and bf16 within 2e-2, and
   ``entry()``'s forward; one f32 AdamW step of 10 folds (dropout 0)
   ``cuda`` against ``cpu``: loss within 1e-5 relative, every gradient
   element within 1e-2 of its parameter's largest |gradient| (a ReLU input
   within rounding of 0 turns a gradient term on or off), the parameters
   within 1e-6 where an element's gradient is ten times its difference and
   at least 1e-6 (so no rounding can turn the step) and within two steps
   elsewhere, where their gradients hold them; one epoch timed and profiled
   (device busy share, host launch calls a step, the top kernels by device
   time); then ``train_cv`` at ``RegressionTrainConfig``'s defaults (10
   folds, 50 epochs, batch 32, lr 3e-4, snapshots from epoch 30, one seed
   replica; epochs cut, and the cut printed, if 50 would take over 60 s):
   wall seconds, ms an epoch, steps/s, peak device memory and the OOF R²,
   which must be above 0.3;
10. the classification ensemble (``train/classification.py``; no kernel of
   its own, its forests run K3, K4, K5 and the forest kernel) over
   ``testing.classification_inputs()`` (the MACCS rows of the 7,809
   labelled molecules), scaled and projected to 30 columns on ``cuda``:
   ``smote_tomek`` on ``cuda`` against ``cpu`` (SMOTE's and Tomek's
   neighbours equal but at near ties, at most 1% of rows, counted); each
   non-forest model of ``default_zoo`` fit on the resampled training rows,
   ``cuda`` against ``cpu`` (kNN and NB exact, logreg 1e-4, svc 1e-3, the
   MLP 1e-3 at 200 Adam steps, labels equal but within that of 0.5; the
   zoo's 800-step MLP, whose runs part with the steps, by test accuracy
   within 1% and ROC AUC within 0.01);
   ``batched_random_search`` of logreg, svc, bnb, knn and mlp at 50 trials
   + the default over 5 folds, ``cuda`` against ``cpu`` (the same best
   trial, CV scores within two validation rows; the MLP's at 200 steps
   within 1% of them, its ``cpu`` side cut to the default + 2 trials; the
   card also runs all 51 at 800 steps, timed); then
   ``run_classification(tune=False)`` on ``cuda`` at full width with every
   launch counter set to 0 just before and read just after (the forest
   kernel's, K3's, K4's and K5's must move): the 12-row report, wall
   seconds by stage, peak memory, and voting's ROC AUC within 0.03 of the
   JAX package's on the CPU over the same rows (``classification_reference.py``,
   a learning check); then ``tune_zoo`` of the five forest families on
   ``cuda``, cut to the default + 1 trial × 5 folds (seconds a fit), one
   fold fit profiled (device busy share, host launch calls) and one MLP
   lane group profiled (host launch calls a step);
11. the regression stack (``train/regression.py``; no kernel of its own:
   its forests run K3, K4, K5 and the forest kernel, its chemistry-kernel
   legs K6, K7 and K8) over a B3DB-format TSV of the 1,058 regression
   molecules: ``preprocess_regression``'s transforms on ``cuda`` against
   ``cpu`` from one featurization (the standardized blocks within 1e-4,
   the PCA blocks and interactions within 3e-4, each times the larger of 1
   and the block's largest |value|; the outlier labels equal but near the
   threshold, at most 1% of rows); the MPNN (hidden 192, 5 layers, 128
   atoms, 10 folds) forward on ``cuda`` against ``cpu`` (f32 1e-4 with TF32
   off, bf16 2e-2, with and without the fold axis) and one f32 step (phase
   9's rule); then ``run_regression(device="cuda")`` at
   ``RegressionTrainConfig()``'s widths through ``$BBBP_B3DB_DIR`` with
   its depth cut (``REG_CUTS``, each cut printed) and every launch counter
   set to 0 just before and read just after (the forest kernel's, K3's,
   K4's, K5's, K6's, K7's and K8's must move): the report, wall seconds by
   stage and peak memory; its knn, ridge, tknn, tkrr and ckrr columns
   against the same estimators on ``cpu`` over its folds (``LEG_TOL``;
   knn rows at a near tie of the 10th neighbour excepted); K3 and K4 at the
   tree matrix's width (458 features) on fold 0's binned rows at levels 0,
   5 and 9, held as phase 5 holds them and timed; and a learning check:
   the stacked R² within 0.03 of the JAX package's on the CPU over the same
   rows at the same depth (``regression_reference.py``), the nn and graph
   legs' OOF R² above 0.3;
12. every remaining model family, through phase 11's B3DB-format directory
   and caches with a classification TSV of the labelled set beside them:
   the BERT encoder (both heads, a PAD row), the dual-branch MLP (eval and
   train mode, BatchNorm's running statistics) and the flow model on the
   card against the CPU, and one f32 MLM step on one mask (``FAM_*``); then,
   with every launch counter set to 0 just before and read just after,
   MLM pretraining, aux pretraining of the graph and multimodal trunks,
   ``run_regression`` at phase 11's cuts with the SMILES leg and both warm
   starts, ``run_weighted_ensemble``, ``search_nn_cv`` over the MLP's
   learning rate and weight decay (2 trials x 5 folds in one ``train_cv``),
   ``run_bert`` and ``do_flow_train`` (each cut printed): wall seconds by
   stage, peak memory, the forest kernel's and K3-K5's launches (they must
   move), and learning checks against floors stated in the code (MLM loss
   falls, aux AUC > 0.5, the SMILES leg's R² > 0.2, nn and graph > 0.3, the
   stacked R² no more than 0.03 below phase 11's, the weighted ensemble's
   R² > 0.3, BERT's and flow's test accuracy > 0.6 and above the test
   split's majority share + 0.02, which a constant prediction scores, and
   their test ROC AUC > 0.6).

13. reporting and the utilities, through phase 11's directory (every launch
   counter set to 0 at its start and read at its end): whether matplotlib
   and PIL import; ``run_classification(tune=False, out_dir)`` at phase 10's
   widths (rf left out and learning curves off, each cut printed) with its
   files checked (the figures, TreeSHAP and kernel SHAP plots only where
   matplotlib imports); TreeSHAP of its boosted forest over 150 rows of
   phase 10's projection, additivity held against the forest kernel's
   margin on the card (1e-4 of max(1, |margin|)); its MLP's predictions on
   the card against the same parameters on the CPU (1e-5, every row kernel
   SHAP evaluates included) and kernel SHAP of them (its f32 solve's phi is
   printed, not held: that solve's rounding is ~5e-3; phi solved again in
   f64 from each device's predictions within 1e-4, efficiency within
   1e-3); integrated gradients of phase 9's regressor (fold 0 in
   f32, TF32 off, 4 rows from another molecule's inputs, 64 steps) on the
   card against the CPU (1e-4 of scale) with its completeness gap held
   (0.2 of the largest |f(x) - f(b)|, the 256-step gap printed); phase 11's
   ``nn_checkpoint`` restored onto the card bit-equal; ``prefetch_to_device``
   onto cuda in order, ``trace`` over one forward and backward (a trace file
   with device time), ``debug_nans`` raising on a NaN made on the card
   forward and backward; ``train_cv`` of phase 9's regressor on its inputs
   (10 folds, 2 epochs) over a 1 x 1 NCCL mesh bit-equal to the run without
   one; ``dryrun_multichip(4)`` (4 gloo processes on the CPU: one card;
   ``torch_dryrun_check.py`` runs it on four cards) against one unsharded
   step on the CPU (bf16 losses within 1e-5 and
   parameters but for first-step sign flips at a rounding, at most 0.5%; f32
   within 1e-5); the featurize, analyze and chemspace CLIs (``--device
   cuda``) over phase 11's TSV, the PCA coordinates against a CPU run within
   3e-4 of scale;
14. the lane-batched forest search (``BBBP_FOREST_VMAP`` on) over phase
   10's search matrix (its training rows after SMOTE-Tomek, 30 PCA
   columns): ``tune_zoo`` of the five forest families at phase 10's trials
   x 5 folds as lanes, family by family, every launch counter set to 0
   before and read after (the fused split search, K5 with lanes and K9
   must move; in cat's search only the fused oblivious search, at the
   levels ``oblivious_fused_levels`` gives its lanes, and K3 then K4 with
   lanes at the others; the single-fit kernels and the forest kernel
   never), each trial's CV
   accuracy within 0.006 of phase 10's
   sequential search, and fold 0 of every trial (its lane in a group fit
   as the search fits it) bit-equal to ``fit_forest`` with the trial's seed:
   margins, trees, thresholds and leaves; then the lane kernels at L = 15
   (3 trials x 5 folds' row weights, lambda 0.1-10 a lane, a lane of 40x
   the others' gradients), levels 0, 5, 9 and 11: K3 bit-equal to its
   fixed-point plain version and to the single-fit kernel lane by lane and
   within one f32 rounding of the float64 sums, K4 (per node, oblivious,
   column masks) equal to the single-fit kernel lane by lane and to its
   plain version but at counted near ties, the sorts of the next level
   given each level's split (the fused search's, K3 with lanes', lane 0's
   single fit) routing as ``route_rows_reference`` does (positions, the
   trees' pairs, each node's rows as a set, results bit-equal to the calls
   on the routed positions), K5 with the next tree and the last level's
   routing (64 and 1,024 leaves) in both launch shapes (a cluster a lane,
   a block a lane) bit-equal to ``route_rows_reference`` then its
   fixed-point plain version and to the single-fit kernel, the fused split
   search (``level_splits_lanes``) bit-equal to K3 then K4 with lanes and to
   its fixed-point plain version but at counted near ties (min_child 0 and
   1, column masks and none); each timed in CUDA graphs beside its plain
   version, its bound (``timing.py``, every lane's share, the shared xb and
   y once; the fused search's operations at the occupied bins counted from
   xb and pos) and, for K3, one ``index_add_`` over the lanes' keys; the
   fused search and K3 then K4 again at L = 250 (50 trials x 5 folds' row
   weights), held bit for bit and timed, the fused search also with each
   warp taking one unit; the fused search of the next level with the
   routing against the same call alone and ``route_rows_reference``, and K5
   with lanes in both shapes, at L = 15 and 250; the fused oblivious search
   (``level_splits_oblivious_lanes``) at L = 15 and 250, levels 0-5, 9 and
   11, given a random split of the level before (half its nodes sending
   every row left), routed in place, bit-equal to K3 then K4 with lanes
   (oblivious) at min_child 0 and 1 with column masks and none, and to its
   fixed-point plain version (every lane at L = 15, every 10th at L = 250)
   but at counted near ties, timed
   beside the two kernels and its bound, at levels 0 and 5 beside K3 with
   lanes' ``index_add_`` and (L = 15) its plain version; then xgb's search
   at 50 + 1 trials
   x 5 folds = 255 lanes, rf's at 50 + 1 (a 250-lane group of 300 trees
   of depth 10) and cat's at 50 + 1 (255 oblivious lanes of 300 trees of
   depth 6): wall s, peak memory, launches, lane blocks, and under
   ``torch.profiler`` the device busy time and the host's launch calls over
   the whole search (at most 4 a tree step; no ``torch.Generator`` draw);
   every lane group of the five searches bit-equal to the eager loop
   (``graph=False``).

Then one JSON line for the kernels (each with its launches in phase 12's
run under ``launches_families`` and in phase 13 under
``launches_reporting``, its time and its plain
version's, its bound from ``bbbp_tpu_torch/timing.py`` and a library
yardstick where one PyTorch call computes the same function; the
projection's ``torch.addmm`` on bits already unpacked is the product alone,
and the ``*_fingerprints`` keys hold its times on the fingerprints; the
two screening kernels carry phase 4's launches by card over two shards,
``launches_two_shards_by_card``, and over every card,
``launches_all_cards_by_card``, where there are several), the
card's ``nvidia-smi`` line, and as the last line
``{"ok": true, "device": {...}}``. There is no CPU fallback: without a CUDA
device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import csv
import ctypes
import json
import os
import signal
import sys
import tempfile
import time

import numpy as np

SLICE_N = 65536 + 1000            # 4 full chunks of 16,384 and a ragged tail
CHUNK = 16384
PREFIX = 2048
INVALID = ("NOT_A_SMILES((", "C1CC", "[Xx]")
TRAIN_ROWS = (7809, 65536)        # B3DB classification's size, and a larger one
TRAIN_DEPTH = 6
TRAIN_F = 30
WIDE_F = 326                      # the transfer path's aux features
WIDE_LEVELS = (0, 5, 9)           # depth 6 (gbdt, oblivious) and depth 10 (rf)
WIDE_FORESTS = ((6, 400), (10, 300))      # (depth, trees) of the aux forests
AUDIT_TREES = 30

REG_FOLDS = 10
FOLD_ROWS = 106                   # a tenth of B3DB regression's 1,058 rows
AUC_FLOOR = 0.6
LEVELS = 16
REG_EPOCH_BUDGET_S = 40.0         # phase 9: train_cv's 50 epochs are cut to
                                  # fit this where they would not (60 s until
                                  # phase 14 came: the whole run took 1,105 s
                                  # on a slow host of the card)
FWD_ROWS = 16                     # rows of phase 9's forward checks
# phase 9's forward, card against CPU: f32 with TF32 off; bf16 rounds at
# other places (bf16 against f32 on the CPU differs by up to 6.3e-3 on
# outputs of ~0.2 at this width)
FWD_TOL = {"f32": 1e-4, "bf16": 2e-2}
# phase 9's f32 training step, card against CPU. A ReLU whose input is
# within rounding of 0 passes its gradient on one side and not on the
# other, so a gradient element can differ by a whole term: on an H100, by
# 0.51% of its parameter's largest |g| (the head's first bias). Every
# gradient element is held within STEP_GRAD_TOL of its parameter's largest
# |g|. Adam's first step, lr·g/(|g| + 1e-8), turns where such a difference
# outweighs g: those parameters are held by their gradients, and are at
# most 2 lr apart (1% more for the decay)
STEP_GRAD_TOL = 1e-2
STEP_TURNED = 2.02

# phase 10: the classification ensemble. Card against CPU on the same
# numpy rows: SMOTE's and Tomek's neighbours may differ only at near ties
# (two distances within 1e-5 relative among the first kk + 1), at most 1%
# of rows; the estimators within the CPU tests' tolerances
# (tests/test_torch_linear.py); a batched search's CV scores within two
# validation rows and the same best trial. Not so the MLP: where a
# gradient is near 0, Adam's step turns on its last bits, so two correct
# runs part, the sooner the more rows and the larger the learning rate
# (tests/test_torch_linear.py: 1.8e-7 after 200 steps on 300 rows; on an
# H100, card against CPU at 8,162 rows: 6.7e-5 after 200 steps, 0.077
# after the zoo's 800; a search trial at lr 3.5e-3 40.6 validation rows
# apart after 200 steps, 255 after 800). The MLP is held at 200 steps
# within 1e-3, and by what it learned at 800: test accuracy within 1% and
# ROC AUC within 0.01; its search at 200 steps within 1% of the
# validation rows, with the same best trial
CLS_NEAR_TIE_RTOL = 1e-5
CLS_NEAR_TIE_SHARE = 0.01
CLS_PROBA_TOL = {"knn": 0.0, "logreg": 1e-4, "svc": 1e-3, "bnb": 0.0,
                 "mlp": 1e-3}
CLS_MLP_EXACT_STEPS = 200
CLS_MLP_ACC_TOL, CLS_MLP_AUC_TOL = 0.01, 0.01
CLS_ROWS_TOL = 2
CLS_MLP_SEARCH_TOL = 0.01         # of the validation rows
CLS_SEARCH_TRIALS = 50            # + the default trial, 5 folds
CLS_MLP_CPU_TRIALS = 2            # the MLP search on the CPU: default + 2
                                  # at 200 steps (51 at 800 take many
                                  # minutes there); the card runs all 51
                                  # at 800 as well, timed
CLS_FOREST_TRIALS = 1             # phase 10's tune_zoo of the forests:
                                  # default + 1 sampled trial (of 50)
# a learning check, not a target: the JAX package's run_classification
# (tune=False) on the CPU over the same rows gives voting a ROC AUC of
# CLS_JAX_VOTING_AUC; the port's must come within 0.03 of it
CLS_JAX_VOTING_AUC = 0.8907
CLS_AUC_MARGIN = 0.03
# phase 11: the regression stack. run_regression at RegressionTrainConfig()'s
# widths, its depth cut (one seed replica of every leg; the NN's 50 epochs
# cut to 3, snapshots from 2 as 30 of 50; the MPNN's 100 to 12).
# regression_reference.py runs the JAX package with the same cuts on the
# CPU, where its bf16 CNN over 10 vmapped folds takes ~30 minutes an epoch:
# at this depth the reference ran 2.2 hours on 8 cores
REG_CUTS = dict(nn_seeds=1, graph_seeds=1, tree_seeds=1, epochs=3,
                snapshot_from=2, graph_epochs=12)
# every preprocessed block, card against CPU, within a tolerance times the
# larger of 1 and the block's largest |value|: the standardized blocks 1e-4
# (column means an ulp apart, over a near-constant pixel column's small
# std: 3.0e-3 on values up to 32.5 on an NVIDIA H100 80GB HBM3 at 700 W),
# the PCA blocks and their interactions 3e-4 (two eigensolvers' f32
# components; fp_pca 1.5e-3 on values up to 15.3), as
# tests/test_torch_preprocess.py holds the port against the JAX package
REG_SCALED_TOL, REG_PROJECTED_TOL = 1e-4, 3e-4
GNN_ROWS = 16                     # molecules of the MPNN's forward checks
# the deterministic legs' columns, card against CPU: knn 1e-4; tknn, tkrr
# and ckrr as phase 8 holds them (top-k 1e-5, the ridge solves 2e-3); the
# ridge leg's f32 Cholesky of X'X + 10 I over 458 features as phase 8's
# ridge solves (2.9e-4 seen on an NVIDIA H100 80GB HBM3 at 700 W)
LEG_TOL = {"knn": 1e-4, "ridge": 2e-3, "tknn": 1e-5, "tkrr": 2e-3, "ckrr": 2e-3}
# a learning check, not a target: the JAX package's run_regression on the
# CPU over the same rows at the same depth (regression_reference.py) gives
# the stacked prediction an R^2 of REG_JAX_STACKED_R2; the port's must come
# within REG_R2_MARGIN of it, and its nn and graph legs above REG_LEG_FLOOR
REG_JAX_STACKED_R2 = 0.8830
REG_R2_MARGIN = 0.03
REG_LEG_FLOOR = 0.3
# phase 12: every remaining model family. The card against the CPU: the
# BERT encoder, the dual-branch MLP and the flow model forward at their
# widths, f32 (TF32 off) within 1e-4 and bf16 within 2e-2 of the larger of
# 1 and the output's scale (independent bf16 roundings of MLM logits of
# scale ~3 part by more than 2e-2: tests/test_torch_bert.py); one f32 MLM
# step on one mask drawn once and moved, held by phase 9's rule but for
# the attention key biases, whose gradient is 0 but for rounding (held
# within STEP_GRAD_TOL of the largest |g| of every parameter); BatchNorm's
# running statistics after a train-mode forward within 1e-5
FAM_ROWS = 16                     # rows of the forward checks
FAM_STATS_TOL = 1e-5
# the flagship path and the other families, each cut printed: MLM
# pretraining over FAM_CORPUS synthetic_smiles (+ the B3DB TSVs) for 1
# epoch; both aux pretrainings at AuxPretrainConfig()'s widths for
# FAM_AUX_EPOCHS; run_regression at phase 11's cuts with the three options,
# bert_seeds 2 -> 1 and bert_epochs 40 -> 12 (snapshots from epoch 2, as
# run_regression sets them: max(1, bert_epochs - 10)); the weighted
# ensemble, the NN search (2 trials x 5 folds, one train_cv of 10
# replicas), run_bert and do_flow_train at their defaults. The graph
# pretraining's 5 epochs and the search's 3 trials were cut to these when
# phase 14 came (the whole run took 1,105 s on a slow host of the card)
FAM_CORPUS = 20_000
FAM_MLM_EPOCHS = 1
FAM_AUX_EPOCHS = {"graph": 3, "multimodal": 1}
FAM_BERT_CUTS = dict(bert_seeds=1, bert_epochs=12)
FAM_SEARCH_TRIALS, FAM_SEARCH_FOLDS = 2, 5
# learning checks, not targets (floors set before the first card run, but
# for the majority share and the ROC AUC of BERT and flow, added after it:
# a two-thirds BBB+ split lets a constant prediction pass 0.6)
FAM_AUC_FLOOR = 0.5               # each aux pretraining's holdout AUC
FAM_SMILES_FLOOR = 0.2            # the SMILES leg's OOF R^2
FAM_STACK_MARGIN = 0.03           # stacked R^2 with every leg vs phase 11's
FAM_WEIGHTED_FLOOR = 0.3          # the weighted ensemble's R^2
FAM_ACC_FLOOR = 0.6               # BERT's and flow's test accuracy, and
FAM_ACC_MARGIN = 0.02             # above the test split's majority share
FAM_CLS_AUC_FLOOR = 0.6           # BERT's and flow's test ROC AUC


# phase 13: reporting and the utilities. run_classification(tune=False,
# out_dir) at phase 10's widths; rf left out there and learning curves cut
# (each printed): the pipeline's TreeSHAP goes to the first forest it has,
# and rf's 200 trees of depth 10 take ~1.2 s a tree of host numpy at 150 rows
REP_CLS_LEFT_OUT = ("rf",)
REP_SHAP_FOREST = "gb"            # TreeSHAP additivity: 200 trees of depth 4
REP_SHAP_ROWS = 150               # as the pipeline takes
REP_ADDITIVITY_TOL = 1e-4         # x max(1, |margin|), the forest kernel's
REP_KSHAP_ROWS = 60               # kernel SHAP of the MLP, as the pipeline
# the MLP's predictions on the card against the CPU (f32, TF32 off), from the
# same parameters
REP_PRED_TOL = 1e-5
# kernel SHAP of the MLP, card against CPU. The JAX package's kernel SHAP
# (copied bit for bit) solves its normal equations in f32 with the anchors
# weighted 1e6: that solve's own rounding moves phi by ~5e-3 (phi up to ~0.4,
# median ~0.03, on a CPU trial over 30 features), and a prediction that moves
# by 3e-7 moves its phi as much, so its phi, card against CPU, can tell no
# wrong attribution from rounding and is printed, not held. Held: every
# prediction the attribution made, card against CPU (REP_PRED_TOL), and phi
# solved again in f64 from each device's recorded predictions (the same
# coalitions, replayed): phi within 1e-4 and efficiency within 1e-3 (on that
# trial 3e-7 of noise in the predictions moved f64 phi by 4e-8, 1e-4 of noise
# by 1.4e-5; efficiency 1.4e-5)
REP_KSHAP_SAMPLES = 256
REP_KSHAP_TOL = 1e-4
REP_EFFICIENCY_TOL = 1e-3
REP_IG_ROWS = 4
REP_IG_STEPS = 64
REP_IG_TOL = 1e-4                 # x max(1, scale), card against CPU
# IG from another molecule's inputs (a zero baseline passes LayerNorm's
# discontinuity at 0, which no number of steps closes): the gap of
# sum(attributions) to f(x) - f(baseline) at 64 steps, of the largest
# |f(x) - f(baseline)|; it shrinks as 1/steps (0.07 at 64, 0.016 at 256 on a
# random init of the model on the CPU)
REP_IG_COMPLETENESS = 0.2
REP_PCA_TOL = 3e-4                # x max(1, scale), card against CPU
REP_DRYRUN_TOL = 1e-5
REP_DRYRUN_FLIPS = 0.005          # bf16: share of elements a rounding's sign
                                  # turns in the first AdamW step
# train_cv over a 1 x 1 NCCL mesh against the run without one: phase 9's
# model, inputs and train_cv settings, its 50 epochs cut to these (snapshots
# from the last of them, as phase 9 takes them from epoch 30)
REP_MESH_EPOCHS = 2
REP_PREFETCH_ITEMS = 12
# phase 14: the lane-batched forest search. Its CV accuracies against phase
# 10's sequential search within LANES_SCORE_TOL (the bound VERDICT r5 held
# the JAX package's vmapped search to); equal where the trees are, but for
# validation rows whose margin is a rounding from the threshold (the lanes
# read the fit's margins, the sequential search the forest kernel's sum)
LANES_SCORE_TOL = 0.006
LANES_L = 15                      # the kernels' lanes: 3 trials x 5 folds
LANES_WIDE_L = 250                # a tuned group's: 50 trials x 5 folds
LANES_LEVELS = (0, 5, 9, 11)      # depth 6 (gb, xgb, cat), 10 (rf), 12 (dt)
OBLIVIOUS_LEVELS = (0, 1, 2, 3, 4, 5, 9, 11)   # cat's depth-6 levels, and deep ones
OBLIVIOUS_LIBRARY_LEVELS = (0, 5)   # where K3 with lanes' index_add_ is timed too
LANES_GROUP_TRIALS = 50           # + the default: xgb's 255-lane group
# phase 6: the tree as one CUDA graph and K9's keyed draws
DRAW_WIDE_L = 255                 # K9's lanes at xgb's tuned group's width
GRAPH_TREES = 30                  # trees of each graph-against-eager fit
# the stochastic fits held card against CPU, cut for the CPU's fit and
# replay (300 and 50 trees took 79 and 46 s on the card's host; 100 and 20
# trees 16 s each on a slow one)
N_TREES_STOCHASTIC = 50           # GBDTClassifier(subsample=0.8, colsample=0.6)
RF_AUDIT_TREES = 10               # RandomForestClassifier, depth 10
MAX_CALLS_A_TREE = 4              # host launch calls a tree of a fit, or a tree
                                  # step of a lane group, under the graph


def read_csv(path: str):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if rows[0] != ["ID", "SMILES", "Prediction", "Probability"]:
        raise AssertionError(f"bad CSV header {rows[0]}")
    return rows[1:]


def screen_against_cpu(model, ensemble_state, mols, gpu_csv, cpu_csv,
                       max_near_share=0.01):
    """Runs ``screen(device="cpu")`` over the first PREFIX molecules and
    holds the cuda run's rows against it: rows may differ only where a path
    meets a threshold within 1e-5 (the two sum z in different orders), and
    such rows are at most ``max_near_share`` (None: no cap). Returns (rows
    that differ, near-tie rows, largest |dProbability| elsewhere)."""
    import torch

    from bbbp_tpu_torch.native.bindings import fingerprints_packed
    from bbbp_tpu_torch.ops.bitops import packed_project_reference
    from bbbp_tpu_torch.pipelines.screen import screen
    from bbbp_tpu_torch.testing import near_tie_rows

    screen(model, iter(mols[:PREFIX]), out_csv=cpu_csv, chunk_size=PREFIX,
           device="cpu")
    gpu_rows, cpu_rows = read_csv(gpu_csv), read_csv(cpu_csv)
    packed_np, _ = fingerprints_packed([s for s, _ in mols[:PREFIX]])
    z_cpu = packed_project_reference(torch.from_numpy(packed_np.view(np.int32)),
                                     model.proj_w.cpu(), model.proj_c0.cpu())
    near = near_tie_rows(ensemble_state, z_cpu.numpy())
    mism, worst = [], 0.0
    for i, (g, c) in enumerate(zip(gpu_rows[:PREFIX], cpu_rows)):
        if g[2] == "invalid" or c[2] == "invalid":
            if g[2:] != c[2:]:
                mism.append(i)
            continue
        diff = abs(float(g[3]) - float(c[3]))
        if g[2] != c[2] or diff > 1e-4 + 1e-9:
            mism.append(i)
        else:
            worst = max(worst, diff)
    if any(not near[i] for i in mism) or (
            max_near_share is not None and near.mean() > max_near_share):
        raise AssertionError(f"cuda vs cpu prefix: rows {mism} differ; near-tie "
                             f"rows {int(near.sum())}")
    return mism, int(near.sum()), worst


def cards_phase(model, mols, one_card_csv: bytes) -> dict:
    """Phase 4 over several shards: the slice's molecules and model screened
    over ["cuda:0", "cuda:0"], then over every card where torch sees more
    than one. Each CSV must be byte-equal to the one-card CSV, and each
    kernel launched once a shard of every chunk, counted by card. Returns
    {"two_shards" | "all_cards": {"devices", "launches", "mol_per_s",
    "wall_s"}}."""
    import torch

    from bbbp_tpu_torch.ops.bitops import packed_project
    from bbbp_tpu_torch.ops.forest import raw_predict
    from bbbp_tpu_torch.pipelines.screen import screen

    n = torch.cuda.device_count()
    splits = {"two_shards": ["cuda:0", "cuda:0"]}
    if n > 1:
        splits["all_cards"] = [f"cuda:{i}" for i in range(n)]
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for key, devices in splits.items():
            chunk = CHUNK // len(devices) * len(devices)
            chunks = -(-len(mols) // chunk)
            path = os.path.join(tmp, f"{key}.csv")
            for kernel in (packed_project, raw_predict):
                kernel.launches.reset()
            stats = screen(model, iter(mols), out_csv=path, chunk_size=chunk,
                           dispatch_workers=2, devices=devices)
            launches = {"packed_project": dict(packed_project.launches.by_device),
                        "dense_forest_predict": dict(raw_predict.launches.by_device)}
            with open(path, "rb") as f:
                if f.read() != one_card_csv:
                    raise AssertionError(f"screen over {devices}: the CSV differs "
                                         f"from one card's")
            want = {}
            for d in devices:
                i = torch.device(d).index
                want[i] = want.get(i, 0) + chunks
            if any(by_card != want for by_card in launches.values()):
                raise AssertionError(f"screen over {devices}: launches by card "
                                     f"{launches}, want {want} each")
            runs[key] = {"devices": devices, "launches": launches,
                         "mol_per_s": stats.mol_per_s, "wall_s": stats.wall_s}
    print("[4 cards] " + " | ".join(
        f"{run['devices']}: {run['mol_per_s']:.1f} mol/s (wall "
        f"{run['wall_s']:.3f} s), launches by card {run['launches']}, CSV "
        f"byte-equal to one card's" for run in runs.values()), flush=True)
    return runs


def ulp_gap(a, b) -> int:
    """Largest distance of two f32 tensors in units in the last place."""
    import torch

    if not a.numel():
        return 0
    return int((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max())


def fmt(values):
    return "[" + ", ".join(f"{v:.4f}" for v in values) + "]"


def level_case(n, n_feat, level, seed, device):
    """Binned rows (two constant features, so whole features tie exactly),
    node positions, and gradients/hessians with 20% zero-weight rows."""
    import torch

    r = np.random.default_rng(seed)
    xb = r.integers(0, 64, (n, n_feat), dtype=np.uint8)
    xb[:, :2] = 9
    pos = r.integers(0, 1 << level, n).astype(np.int32)
    g = r.normal(size=n).astype(np.float32)
    h = r.uniform(0.05, 0.3, n).astype(np.float32)
    zero = r.random(n) < 0.2
    g[zero] = 0.0
    h[zero] = 0.0
    return [torch.from_numpy(a).to(device) for a in (xb, pos, g, h)]


def index_add_call(xb, pos, g, h, nodes):
    """One ``index_add_`` that computes K3's function, its keys and values
    made beforehand (the call ``level_histogram_reference`` ends in)."""
    import torch

    n, n_feat = xb.shape
    keys = (pos.long()[:, None] * (n_feat * 64)
            + torch.arange(n_feat, device=xb.device)[None, :] * 64
            + xb.long()).reshape(-1)
    vals = torch.stack([g, h], dim=1)[:, None, :].expand(n, n_feat, 2).reshape(-1, 2)
    return lambda: torch.zeros((nodes * n_feat * 64, 2), device=xb.device
                               ).index_add_(0, keys, vals)


def split_mismatches(tr, hist, mask, min_child, oblivious, got, want, lam=1.0):
    """Nodes where the kernel's split differs from the plain version's; each
    must be a near tie (the two candidates' scores within 1e-6 of the
    node's largest |score|), or this raises. Returns their count and the
    largest |score(kernel split) - score(plain split)| among them (0 when
    every node is equal)."""
    import torch

    differ = ~((got[0] == want[0]) & (got[1] == want[1]) & (got[2] == want[2]))
    if not bool(differ.any()):
        return 0, 0.0
    gain, valid = tr.split_gains(hist, mask, lam, min_child)
    if oblivious:
        score = torch.where(valid & (gain > 0), gain, torch.zeros_like(gain)).sum(0)
        score = torch.where(valid.any(0), score, -torch.inf).reshape(1, -1)
    else:
        score = torch.where(valid, gain, -torch.inf).reshape(hist.shape[0], -1)
    worst = 0.0
    for node in torch.nonzero(differ).flatten().tolist():
        row = score[0 if oblivious else node]
        a = row[int(got[0][node]) * 64 + int(got[1][node])]
        b = row[int(want[0][node]) * 64 + int(want[1][node])]
        scale = float(row[torch.isfinite(row)].abs().max())
        if not (got[2][node] and want[2][node]) or abs(float(a - b)) > 1e-6 * scale:
            raise AssertionError(f"best_splits node {node}: kernel "
                                 f"{[int(t[node]) for t in got]}, plain "
                                 f"{[int(t[node]) for t in want]}")
        worst = max(worst, abs(float(a - b)))
    return int(differ.sum()), worst


def occupied_cells(xb, pos, g, h, nodes) -> int:
    """The (lane, node, feature, bin) cells that hold a row of non-zero
    weight, counted on the host from xb and pos (pos [L, n]): the cells
    whose gains the fused split search needs (``level_splits_bound``)."""
    codes = xb.cpu().numpy().astype(np.int64)
    n_feat = codes.shape[1]
    codes += np.arange(n_feat) * 64
    live = ((g != 0) | (h != 0)).cpu().numpy()
    total = 0
    for p, keep in zip(pos.cpu().numpy().astype(np.int64), live):
        seen = np.zeros(nodes * n_feat * 64, bool)
        seen[(p[keep, None] * (n_feat * 64) + codes[keep]).ravel()] = True
        total += int(seen.sum())
    return total


def one_unit_ms(tr, device_ms, fn, **kw) -> float:
    """``device_ms(fn)`` with each warp of the fused split search taking one
    unit (``split_run`` held at 1): what its runs of units save."""
    saved = tr.SPLIT_MAX_RUN
    tr.SPLIT_MAX_RUN = 1
    try:
        return device_ms(fn, **kw)
    finally:
        tr.SPLIT_MAX_RUN = saved


def hold_fused(tr, xb, pos, g, h, nodes, bounds, n_bins, hist, masks, lam, problems,
               held, plain_lanes=None):
    """The fused split search at min_child 0 and 1 for each column mask:
    bit-equal to K4 with lanes on K3 with lanes' histogram ``hist``, and,
    on ``plain_lanes`` (default all), to its fixed-point plain version but
    at counted near ties."""
    import torch

    lanes = pos.shape[0]
    picked = range(lanes) if plain_lanes is None else plain_lanes
    lam_host = lam.tolist()
    for min_child in (0.0, 1.0):
        for col in masks:
            got = tr.level_splits_lanes(xb, pos, g, h, nodes, bounds, col, lam,
                                        min_child, n_bins, bins_checked=True)
            two = tr.best_splits_lanes(hist, col, lam, min_child, False)
            sub = list(picked)
            want = tr.level_splits_lanes_fixed_reference(
                xb, pos[sub], g[sub], h[sub], nodes, col[sub], [lam_host[i] for i in sub],
                min_child, bounds[sub])
            torch.cuda.synchronize()
            off = sum(int((a != b).sum()) for a, b in zip(got, two))
            if off:
                problems.append(f"level_splits_lanes L={lanes} level {nodes.bit_length() - 1} "
                                f"min_child {min_child}: {off} values off K3 then K4 "
                                f"with lanes")
            for j, i in enumerate(sub):
                near, worst = split_mismatches(tr, hist[i], col[i], min_child, False,
                                               [a[i] for a in got], [b[j] for b in want],
                                               lam=lam_host[i])
                held["fused_near"] += near
                held["fused_err"] = max(held["fused_err"], worst)
            held["fused_calls"] += 1


def oblivious_levels(tr, device_ms, xb, y, w, n_bins, lanes, gen, problems, held,
                     plain=False, plain_lanes=None) -> dict:
    """The fused oblivious search (``level_splits_oblivious_lanes``) over
    ``lanes`` lanes at each of ``OBLIVIOUS_LEVELS``: given a random split of
    the level before (half its nodes sending every row left, so that nodes
    are empty), routed in place, bit-equal to K3 with lanes then K4 with
    lanes (oblivious) on the routed positions, at min_child 0 and 1, with a
    column mask and without, lambda 0.1-10 a lane and a lane of 40x
    gradients, and, on ``plain_lanes`` (default all), equal to its
    fixed-point plain version but at counted near ties (a lane's level
    whose split differs; the largest score gap in ``held``); then timed on
    the routed positions beside the two kernels,
    its bound and, at ``OBLIVIOUS_LIBRARY_LEVELS``, one ``index_add_`` over
    the lanes' keys (K3 with lanes' library call) and, with ``plain``, its
    plain version."""
    import torch

    from bbbp_tpu_torch.timing import level_splits_oblivious_bound

    cuda = xb.device
    n, n_feat = xb.shape
    p = torch.sigmoid(torch.randn(lanes, n, generator=gen, device=cuda))
    g = (p - y) * w
    h = torch.clamp(p * (1 - p), min=1e-6) * w
    g[1] *= 40.0
    bounds = tr.gradient_bounds(g, h)
    lam = torch.logspace(-1, 1, lanes, device=cuda)
    lam_host = lam.tolist()
    mask = torch.rand(lanes, n_feat, generator=gen, device=cuda) < 0.7
    mask[:, -1] = True
    every = torch.ones(lanes, n_feat, dtype=torch.bool, device=cuda)
    sub = list(range(lanes) if plain_lanes is None else plain_lanes)
    timed = {}
    for level in OBLIVIOUS_LEVELS:
        nodes = 1 << level
        parent_nodes = max(nodes // 2, 1)
        start = torch.randint(0, parent_nodes, (lanes, n), generator=gen,
                              dtype=torch.int32, device=cuda)
        f_p = torch.randint(0, n_feat, (lanes, parent_nodes), generator=gen,
                            dtype=torch.int32, device=cuda)
        b_p = torch.randint(0, 64, (lanes, parent_nodes), generator=gen,
                            dtype=torch.int32, device=cuda)
        b_p[:, ::2] = 63
        feats = torch.zeros((lanes, 1, 2 * nodes), dtype=torch.int32, device=cuda)
        bins = torch.zeros_like(feats)
        pos = start.clone()
        if level:
            tr.route_rows_reference(xb, pos, f_p, b_p, feats.clone(), bins.clone(), 0,
                                    level - 1)
        hist = tr.level_histogram_lanes(xb, pos, g, h, nodes, bounds, n_bins,
                                        bins_checked=True)
        for min_child in (0.0, 1.0):
            for col in (mask, every):
                routed = start.clone()
                got = tr.level_splits_oblivious_lanes(
                    xb, routed, g, h, nodes, bounds, col, lam, min_child,
                    parent=tr.ParentSplit(f_p, b_p, feats, bins, 0, level - 1)
                    if level else None)
                two = tr.best_splits_lanes(hist, col, lam, min_child, True)
                want = tr.level_splits_lanes_fixed_reference(
                    xb, pos[sub], g[sub], h[sub], nodes, col[sub],
                    [lam_host[i] for i in sub], min_child, bounds[sub], oblivious=True)
                torch.cuda.synchronize()
                off = sum(int((a != b).sum()) for a, b in zip(got, two))
                if off or not torch.equal(routed, pos):
                    problems.append(f"level_splits_oblivious_lanes L={lanes} level {level} "
                                    f"min_child {min_child}: {off} values off K3 then K4 "
                                    f"with lanes, positions "
                                    f"{int((routed != pos).sum())} off")
                for j, i in enumerate(sub):
                    near, worst = split_mismatches(tr, hist[i], col[i], min_child, True,
                                                   [a[i] for a in got], [b[j] for b in want],
                                                   lam=lam_host[i])
                    held["oblivious_near"] += bool(near)
                    held["oblivious_err"] = max(held["oblivious_err"], worst)
                held["oblivious_calls"] += 1
        few = dict(calls=2, replays=5) if level >= 9 else {}
        t = {"fused": device_ms(lambda: tr.level_splits_oblivious_lanes(
                 xb, pos, g, h, nodes, bounds, every, lam, 1.0)),
             "k3": device_ms(lambda: tr.level_histogram_lanes(
                 xb, pos, g, h, nodes, bounds, n_bins, bins_checked=True), **few),
             "k4": device_ms(lambda: tr.best_splits_lanes(hist, every, lam, 1.0, True),
                             **few),
             "bound": level_splits_oblivious_bound(n, n_feat, nodes, lanes)}
        t["two"] = t["k3"] + t["k4"]
        if level in OBLIVIOUS_LIBRARY_LEVELS:
            keys = (torch.arange(lanes, device=cuda)[:, None, None] * (nodes * n_feat * 64)
                    + pos.long()[:, :, None] * (n_feat * 64)
                    + torch.arange(n_feat, device=cuda)[None, None, :] * 64
                    + xb.long()[None]).reshape(-1)
            vals = torch.stack([g, h], dim=-1)[:, :, None, :].expand(
                lanes, n, n_feat, 2).reshape(-1, 2)
            t["k3_library"] = device_ms(lambda: torch.zeros(
                (lanes * nodes * n_feat * 64, 2), device=cuda).index_add_(0, keys, vals))
            del keys, vals
        if plain and level in OBLIVIOUS_LIBRARY_LEVELS:
            t["plain"] = device_ms(lambda: tr.level_splits_lanes_reference(
                xb, pos, g, h, nodes, every, lam_host, 1.0, oblivious=True),
                calls=2, replays=3)
        timed[level] = t
        del hist
        torch.cuda.empty_cache()
    return timed


def hold_lane_routing(tr, xb, pos, g, h, bounds, n_bins, f_l, b_l, level, col, lam,
                      problems, held, sort_lanes=None, with_k3=True):
    """The sorts of level + 1 given level ``level``'s split over lanes (the
    fused search's, with ``with_k3`` K3 with lanes' and, for lane 0, the
    single fit's): the
    positions and the trees' pairs equal ``route_rows_reference``'s, each
    node's sorted rows as a set (on ``sort_lanes``, default all), and the
    results bit-equal to the same calls on the routed positions. Returns
    what ``time_lane_routing`` needs."""
    import torch

    lanes, n = pos.shape
    n_feat = xb.shape[1]
    children = 2 << level
    feats = torch.zeros((lanes, 1, children - 1), dtype=torch.int32, device=xb.device)
    bins = torch.zeros_like(feats)
    routed, f_r, b_r = pos.clone(), feats.clone(), bins.clone()
    tr.route_rows_reference(xb, routed, f_l, b_l, f_r, b_r, 0, level)
    parent = tr.ParentSplit(f_l, b_l, feats, bins, 0, level)
    scratch = torch.empty(lanes * tr.lane_words(n, n_feat, children), dtype=torch.int64,
                          device=xb.device)
    picked = range(lanes) if sort_lanes is None else sort_lanes
    label = f"L={lanes} level {level} -> {level + 1}"
    calls = [("fused", lambda p, **kw: tr.level_splits_lanes(
        xb, p, g, h, children, bounds, col, lam, 1.0, n_bins, bins_checked=True, **kw))]
    if with_k3:
        calls.append(("K3 with lanes", lambda p, **kw: tr.level_histogram_lanes(
            xb, p, g, h, children, bounds, n_bins, bins_checked=True, **kw)))
    for name, call in calls:
        feats.zero_()
        bins.zero_()
        p_k = pos.clone()
        got = call(p_k, parent=parent, scratch=scratch)
        want = call(routed.clone())
        torch.cuda.synchronize()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        if not (torch.equal(p_k, routed) and torch.equal(feats, f_r)
                and torch.equal(bins, b_r)):
            problems.append(f"{name} with routing {label}: "
                            f"{int((p_k != routed).sum())} positions off "
                            f"route_rows_reference")
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            problems.append(f"{name} with routing {label}: not the call on the routed "
                            f"positions")
        if not all(sort_rows_held(tr, scratch, n, n_feat, children, routed[i], g[i], h[i],
                                  i) for i in picked):
            problems.append(f"{name} with routing {label}: a node's sorted rows differ")
        held["routed_sorts"] += 1
    if not with_k3:
        return {"parent": parent, "routed": routed, "children": children}
    p1 = pos[0].clone()
    one = tr.level_histogram(xb, p1, g[0], h[0], children, bounds[0], n_bins,
                             bins_checked=True,
                             parent=tr.ParentSplit(f_l[0].contiguous(), b_l[0].contiguous(),
                                                   feats[0].clone(), bins[0].clone(), 0,
                                                   level))
    if not (torch.equal(p1, routed[0]) and torch.equal(
            one, tr.level_histogram(xb, routed[0].clone(), g[0], h[0], children, bounds[0],
                                    n_bins, bins_checked=True))):
        problems.append(f"K3 with routing {label}: lane 0's single fit differs")
    return {"parent": parent, "routed": routed, "children": children}


def time_lane_routing(tr, device_ms, xb, pos, g, h, bounds, n_bins, col, lam, routing):
    """Device ms of the fused search of level + 1 with the routing of level's
    split (pos restored from the parents' before each call, the copy timed
    alone and taken off), of the same search alone on the routed positions
    (the same copy), and of ``route_rows_reference``, the routing's plain
    version; the routing's added bound."""
    import torch

    from bbbp_tpu_torch.timing import routing_bound

    lanes, n = pos.shape
    children, parent, routed = routing["children"], routing["parent"], routing["routed"]
    p_t = pos.clone()
    f_t, b_t = parent.feats.clone(), parent.bins.clone()

    def fused(p, src, **kw):
        p.copy_(src)
        return tr.level_splits_lanes(xb, p, g, h, children, bounds, col, lam, 1.0, n_bins,
                                     bins_checked=True, **kw)

    copy = device_ms(lambda: p_t.copy_(pos))
    with_routing = device_ms(lambda: fused(p_t, pos, parent=parent)) - copy
    alone = device_ms(lambda: fused(p_t, routed)) - copy
    plain = device_ms(lambda: (p_t.copy_(pos), tr.route_rows_reference(
        xb, p_t, parent.f_l, parent.b_l, f_t, b_t, 0, parent.level))) - copy
    torch.cuda.synchronize()
    return {"route_fused": with_routing, "route_alone": alone,
            "route": with_routing - alone, "route_plain": plain, "route_copy": copy,
            "route_bound": routing_bound(n, children // 2, lanes)}


def k5_line(k5) -> str:
    """K5 with lanes' times at 64 / 1,024 leaves: the chosen shape, each form,
    the plain version where timed, the bound."""
    def two(field):
        return " / ".join(f"{k5[leaves][field]:.4f}" for leaves in (64, 1024))

    plain = f", plain {two('plain_ms')}" if "plain_ms" in k5[64] else ""
    return (f"{two('ms')} (a cluster a lane {two('ms_cluster')}, a block a lane "
            f"{two('ms_block')}){plain}, bound " + " / ".join(
                f"{k5[leaves]['bound']['bound_ms']:.6f}" for leaves in (64, 1024)))


def lane_leaf_case(tr, xb, g, h, bounds, n_leaves, lam, scale, sub, w, y, margins, gen):
    """One tree's last step over lanes as a fit reaches it: the parents'
    positions, the last level's split (random), the routed positions
    (``route_rows_reference``), the next tree's draw."""
    import torch

    lanes, n = g.shape
    dev = xb.device
    half = n_leaves // 2
    pos = torch.randint(0, half, (lanes, n), generator=gen, dtype=torch.int32, device=dev)
    f_l = torch.randint(0, xb.shape[1], (lanes, half), generator=gen, dtype=torch.int32,
                        device=dev)
    b_l = torch.randint(0, 64, (lanes, half), generator=gen, dtype=torch.int32, device=dev)
    feats = torch.zeros((lanes, 1, n_leaves - 1), dtype=torch.int32, device=dev)
    bins = torch.zeros_like(feats)
    parent = tr.ParentSplit(f_l, b_l, feats, bins, 0, half.bit_length() - 1)
    routed, f_r, b_r = pos.clone(), feats.clone(), bins.clone()
    tr.route_rows_reference(xb, routed, f_l, b_l, f_r, b_r, 0, parent.level)
    u = torch.rand(lanes, n, generator=gen, device=dev)
    return {"pos": pos, "parent": parent, "routed": routed, "trees": (f_r, b_r), "u": u,
            "n_leaves": n_leaves, "next": tr.NextTree(y, u, sub, w, "cls"),
            "next_host": tr.NextTree(y, u, sub.tolist(), w, "cls"), "lam": lam,
            "scale": scale, "g": g, "h": h, "bounds": bounds, "xb": xb,
            "margins": margins}


def hold_lane_leaves(tr, case, problems, label, plain_lanes=None) -> dict:
    """K5 with lanes, the next tree and routing, in each launch shape: the
    same bits in all, pos left as it is, the trees' pairs and (on
    ``plain_lanes``, default all) every output bit-equal to
    ``route_rows_reference`` then the fixed-point plain version. Returns the
    cluster form's margins and outputs."""
    import torch

    pos, parent, n_leaves = case["pos"], case["parent"], case["n_leaves"]
    g, h, bounds, xb, margins = case["g"], case["h"], case["bounds"], case["xb"], \
        case["margins"]
    lam, scale = case["lam"], case["scale"]
    picked = list(range(pos.shape[0]) if plain_lanes is None else plain_lanes)
    p_f = margins[picked].clone()
    nxt = case["next_host"]
    want = tr.leaf_values_lanes_fixed_reference(
        case["routed"][picked], g[picked], h[picked], n_leaves,
        [lam.tolist()[i] for i in picked], [scale.tolist()[i] for i in picked], p_f,
        bounds[picked], tr.NextTree(nxt.y, nxt.u[picked], [nxt.subsample[i] for i in picked],
                                    nxt.w_rows[picked], "cls"))
    first = None
    for shape in ("cluster", "block", "auto"):
        parent.feats.zero_()
        parent.bins.zero_()
        p_k, kept = margins.clone(), pos.clone()
        got = tr.leaf_values_lanes(kept, g, h, n_leaves, lam, scale, p_k, bounds,
                                   case["next"], parent=parent, xb=xb, shape=shape)
        torch.cuda.synchronize()
        if first is None:
            first = {"margins": p_k, "out": got}
        elif not (torch.equal(p_k, first["margins"])
                  and all(torch.equal(a, b) for a, b in zip(got, first["out"]))):
            problems.append(f"leaf_values_lanes {label} {n_leaves} leaves: the {shape} "
                            f"form's bits differ from the cluster form's")
        if not (torch.equal(kept, pos) and torch.equal(parent.feats, case["trees"][0])
                and torch.equal(parent.bins, case["trees"][1])):
            problems.append(f"leaf_values_lanes {label} {n_leaves} leaves {shape}: pos "
                            f"changed or the trees' pairs differ")
        if not (torch.equal(p_k[picked], p_f) and all(
                torch.equal(a[picked], b) for a, b in zip(got, want))):
            problems.append(f"leaf_values_lanes {label} {n_leaves} leaves {shape}: not "
                            f"route_rows_reference then the fixed-point plain version")
    return first


def time_lane_leaves(tr, device_ms, leaf_values_bound, case, xb, g, h, bounds, lam, scale,
                     margins, n_feat, slow=None) -> dict:
    """K5 with lanes, the next tree and routing: device ms in the chosen
    shape and in each form, the plain version's (route_rows_reference into
    a copy, then the plain leaves and gradients; with ``slow``), the
    bound."""
    lanes = g.shape[0]
    n_leaves, parent, pos = case["n_leaves"], case["parent"], case["pos"]
    p_t = margins.clone()

    def k5(shape):
        return device_ms(lambda: tr.leaf_values_lanes(
            pos, g, h, n_leaves, lam, scale, p_t, bounds, case["next"], parent=parent,
            xb=xb, shape=shape))

    out = {"ms": k5("auto"), "ms_cluster": k5("cluster"), "ms_block": k5("block"),
           "bound": leaf_values_bound(g.shape[1], n_leaves, True, lanes, n_feat)}
    if slow is not None:
        lam_host, scale_host = lam.tolist(), scale.tolist()

        def plain():
            routed = pos.clone()
            tr.route_rows_reference(xb, routed, parent.f_l, parent.b_l, parent.feats,
                                    parent.bins, 0, parent.level)
            return tr.leaf_values_lanes_reference(routed, g, h, n_leaves, lam_host,
                                                  scale_host, p_t, case["next_host"])

        out["plain_ms"] = device_ms(plain, **slow)
    return out


def hold_level(tr, label, xb, pos, g, h, n_bins, nodes, rng, held):
    """K3 and K4 on one level's inputs against their plain versions.
    K3: bit-equal to the fixed-point plain version with and without
    ``n_bins``, two runs bit-identical, within one f32 rounding of the
    float64 sum. K4 on K3's histogram: per node and oblivious, with column
    masks and min_child, with the plain version's best feature masked out,
    and with a min_child no bin reaches; equal to the plain version but at
    near ties, which ``split_mismatches`` counts."""
    import torch

    n, n_feat = xb.shape
    bounds = tr.gradient_bounds(g, h)
    hist = tr.level_histogram(xb, pos, g, h, nodes)
    again = tr.level_histogram(xb, pos, g, h, nodes, bounds)
    with_bins = tr.level_histogram(xb, pos, g, h, nodes, bounds, n_bins)
    fixed = tr.level_histogram_fixed_reference(xb, pos, g, h, nodes, bounds)
    torch.cuda.synchronize()
    if not torch.equal(hist, again):
        raise AssertionError(f"level_histogram {label}: two runs differ")
    if not (torch.equal(hist, fixed) and torch.equal(with_bins, fixed)):
        raise AssertionError(
            f"level_histogram {label}: differs from its fixed-point plain version "
            f"in {int((hist != fixed).sum())} bins, with n_bins in "
            f"{int((with_bins != fixed).sum())}")
    del again, with_bins, fixed
    exact = tr.level_histogram_reference(xb, pos, g.double(), h.double(), nodes)
    plain = tr.level_histogram_reference(xb, pos, g, h, nodes)
    vmax = max(float(g.abs().max()), float(h.abs().max()))
    err = (hist.double() - exact).abs()
    if bool((err > 2.4e-7 * exact.abs() + 1e-9 * n * vmax).any()):
        raise AssertionError(f"level_histogram {label}: max |err| "
                             f"{float(err.max()):.3g}")
    held["k3_cases"] += 1
    held["k3_err"] = max(held["k3_err"], float(err.max()))
    held["k3_err_plain"] = max(held["k3_err_plain"], float((hist - plain).abs().max()))
    del exact, plain, err

    def hold_splits(mask, min_child, obl):
        got = tr.best_splits(hist, mask, 1.0, min_child, obl)
        want = tr.best_splits_reference(hist, mask, 1.0, min_child, obl)
        near, worst = split_mismatches(tr, hist, mask, min_child, obl, got, want)
        held["k4_near"] += near
        held["k4_err"] = max(held["k4_err"], worst)
        held["k4_calls"] += 1
        return want

    every = torch.ones(n_feat, dtype=torch.bool, device=xb.device)
    level = nodes.bit_length() - 1
    if level < tr.MAX_DEPTH - 1:            # the next level's sort routes this split
        f_l, b_l, _ = tr.best_splits(hist, every, 1.0, 1.0, False)
        hold_routed_sort(tr, label, xb, pos, g, h, n_bins, f_l, b_l, level, held)
    for share, obl, min_child in ((1.0, False, 1.0), (0.5, False, 1.0),
                                  (1.0, False, 4.0), (1.0, True, 1.0),
                                  (0.5, True, 4.0)):
        mask = torch.from_numpy(rng.random(n_feat) < share)
        mask[-1] = True
        want = hold_splits(mask.to(xb.device), min_child, obl)
        if share == 1.0 and min_child == 1.0 and n_feat > 1:
            without_best = every.clone()        # the level's (or node 0's) winner
            without_best[int(want[0][0])] = False
            hold_splits(without_best, min_child, obl)
    for obl in (False, True):                   # no bin holds this much
        want = hold_splits(every, 1e9, obl)
        if bool(want[2].any()):
            raise AssertionError(f"best_splits {label}: a split at min_child 1e9")


def sort_rows_held(tr, scratch, n, n_feat, nodes, pos, g, h, lane=0) -> bool:
    """The sort's row order in ``scratch`` (lane ``lane``): each node's
    rows, as a set, are the rows of weight not 0 that ``pos`` puts there."""
    import torch

    node, row = tr.sorted_rows(scratch, n, n_feat, nodes, lane)
    kept = torch.nonzero(((g != 0) | (h != 0)).cpu()).flatten()
    return sorted(zip(node.tolist(), row.tolist())) == \
        sorted(zip(pos.cpu()[kept].tolist(), kept.tolist()))


def hold_routed_sort(tr, label, xb, pos, g, h, n_bins, f_l, b_l, level, held):
    """K3 of level + 1 given level ``level``'s split (one fit): its sort
    routes every row as it reads it. Positions and the tree's pairs equal
    ``route_rows_reference``'s, each node's sorted rows as a set, and the
    histogram bit-equal to the fixed-point plain version on the routed
    rows."""
    import torch

    n, n_feat = xb.shape
    children = 2 << level
    feats = torch.zeros((2, children - 1), dtype=torch.int32, device=xb.device)
    bins = torch.zeros_like(feats)
    routed, f_r, b_r = pos.clone(), feats.clone(), bins.clone()
    tr.route_rows_reference(xb, routed, f_l, b_l, f_r, b_r, 1, level)
    bounds = tr.gradient_bounds(g, h)
    scratch = torch.empty(tr.histogram_plan(n, n_feat, children)["words"],
                          dtype=torch.int64, device=xb.device)
    p_k = pos.clone()
    hist = tr.level_histogram(xb, p_k, g, h, children, bounds, n_bins,
                              parent=tr.ParentSplit(f_l, b_l, feats, bins, 1, level),
                              scratch=scratch)
    fixed = tr.level_histogram_fixed_reference(xb, routed, g, h, children, bounds)
    torch.cuda.synchronize()
    if not (torch.equal(p_k, routed) and torch.equal(feats, f_r)
            and torch.equal(bins, b_r)):
        raise AssertionError(f"K3 with routing {label}: {int((p_k != routed).sum())} "
                             f"positions off route_rows_reference")
    if not torch.equal(hist, fixed):
        raise AssertionError(f"K3 with routing {label}: {int((hist != fixed).sum())} "
                             f"bins off its fixed-point plain version")
    if not sort_rows_held(tr, scratch, n, n_feat, children, routed, g, h):
        raise AssertionError(f"K3 with routing {label}: the sort's rows of a node "
                             f"differ from the routed positions'")
    held["routed_sorts"] += 1


def hold_routed_leaves(tr, label, xb, pos, g, h, n_leaves, start, bounds, rng, held,
                       next_tree=None):
    """K5 given the last level's split (``pos`` its parents): each row routed
    as it is read, pos left as it is; leaves, margins and (with
    ``next_tree``) the next gradients and bounds bit-equal to
    ``route_rows_reference`` then ``leaf_values_fixed_reference`` and the
    torch ops."""
    import torch

    n, n_feat = xb.shape
    last, half = n_leaves.bit_length() - 2, n_leaves // 2
    dev = xb.device
    f_l = torch.from_numpy(rng.integers(0, n_feat, half).astype(np.int32)).to(dev)
    b_l = torch.from_numpy(rng.integers(0, 64, half).astype(np.int32)).to(dev)
    feats = torch.zeros((1, n_leaves - 1), dtype=torch.int32, device=dev)
    bins = torch.zeros_like(feats)
    routed, f_r, b_r = pos.clone(), feats.clone(), bins.clone()
    tr.route_rows_reference(xb, routed, f_l, b_l, f_r, b_r, 0, last)
    p_r, p_k, kept = start.clone(), start.clone(), pos.clone()
    want = tr.leaf_values_fixed_reference(routed, g, h, n_leaves, 1.0, 0.1, p_r, bounds)
    if next_tree is not None:
        want = (want, *tr.next_gradients_reference(p_r, *next_tree))
    got = tr.leaf_values(kept, g, h, n_leaves, 1.0, 0.1, p_k, bounds, next_tree,
                         parent=tr.ParentSplit(f_l, b_l, feats, bins, 0, last), xb=xb)
    torch.cuda.synchronize()
    same = (all(torch.equal(a, b) for a, b in zip(got, want)) if next_tree is not None
            else torch.equal(got, want))
    if not (same and torch.equal(p_k, p_r) and torch.equal(kept, pos)
            and torch.equal(feats, f_r) and torch.equal(bins, b_r)):
        raise AssertionError(f"K5 with routing {label}: not route_rows_reference then "
                             f"its fixed-point plain version")
    held["routed_leaves"] += 1


def time_routed_sort(tr, xb, g, h, bounds, n_bins, level, seed) -> dict:
    """Single-fit K3 at ``level`` with the routing of the level before (a
    random split over random parents; pos restored before each call, the
    copy timed alone and taken off) and alone on the routed positions (the
    same copy), and the routing's added bound."""
    import torch

    from bbbp_tpu_torch.timing import device_ms, routing_bound

    n, n_feat = xb.shape
    nodes, half = 1 << level, 1 << (level - 1)
    r = np.random.default_rng(seed)
    dev = xb.device
    parents = torch.from_numpy(r.integers(0, half, n).astype(np.int32)).to(dev)
    f_l = torch.from_numpy(r.integers(0, n_feat, half).astype(np.int32)).to(dev)
    b_l = torch.from_numpy(r.integers(0, 64, half).astype(np.int32)).to(dev)
    feats = torch.zeros((1, nodes - 1), dtype=torch.int32, device=dev)
    bins = torch.zeros_like(feats)
    routed = parents.clone()
    tr.route_rows_reference(xb, routed, f_l, b_l, feats.clone(), bins.clone(), 0,
                            level - 1)
    parent = tr.ParentSplit(f_l, b_l, feats, bins, 0, level - 1)
    p_t = parents.clone()

    def k3(src, **kw):
        p_t.copy_(src)
        return tr.level_histogram(xb, p_t, g, h, nodes, bounds, n_bins, bins_checked=True,
                                  **kw)

    copy = device_ms(lambda: p_t.copy_(parents))
    with_routing = device_ms(lambda: k3(parents, parent=parent)) - copy
    alone = device_ms(lambda: k3(routed)) - copy
    return {"k3_routed": with_routing, "k3_alone": alone,
            "k3_routing": with_routing - alone,
            "k3_routing_bound": routing_bound(n, half)}


def time_leaf_values(tr, pos, g, h, n_leaves, bounds, xb):
    """K5's times on one tree's rows: the leaves alone (as the random forest
    and a fit's last tree call it) and with the next boosted tree's
    gradients (every other tree of a boosted fit), each beside its plain
    version and its bound; and with the next tree, routing the last level's
    split over ``xb`` (``pos // 2`` its parents), as a fit calls it."""
    import torch

    from bbbp_tpu_torch.timing import device_ms, leaf_values_bound

    n = pos.shape[0]
    margins = torch.zeros(n, device=pos.device)
    y = (torch.rand(n, device=pos.device) < 0.4).float()
    nxt = tr.NextTree(y, torch.rand(n, device=pos.device), 0.8,
                      torch.ones(n, device=pos.device), "cls")
    half = n_leaves // 2
    parent = tr.ParentSplit(
        torch.randint(0, xb.shape[1], (half,), dtype=torch.int32, device=pos.device),
        torch.randint(0, 64, (half,), dtype=torch.int32, device=pos.device),
        torch.zeros((1, n_leaves - 1), dtype=torch.int32, device=pos.device),
        torch.zeros((1, n_leaves - 1), dtype=torch.int32, device=pos.device), 0,
        half.bit_length() - 1)
    parents = pos // 2
    return {"k5_next_routed": device_ms(lambda: tr.leaf_values(
                parents, g, h, n_leaves, 1.0, 0.1, margins, bounds, nxt, parent=parent,
                xb=xb)),
            "k5_next_routed_bound": leaf_values_bound(n, n_leaves, True, 1, xb.shape[1]),
            "k5": device_ms(lambda: tr.leaf_values(pos, g, h, n_leaves, 1.0, 0.1,
                                                   margins, bounds)),
            "k5_plain": device_ms(lambda: tr.leaf_values_reference(
                pos, g, h, n_leaves, 1.0, 0.1, margins)),
            "k5_bound": leaf_values_bound(n, n_leaves),
            "k5_next": device_ms(lambda: tr.leaf_values(pos, g, h, n_leaves, 1.0, 0.1,
                                                        margins, bounds, nxt)),
            "k5_next_plain": device_ms(lambda: (
                tr.leaf_values_reference(pos, g, h, n_leaves, 1.0, 0.1, margins),
                tr.next_gradients_reference(margins, *nxt))),
            "k5_next_bound": leaf_values_bound(n, n_leaves, next_tree=True)}


def similarity_phase(cuda, card, aux_raw, reg_raw):
    """Phase 7. ``aux_raw`` and ``reg_raw`` are (descriptors, MACCS, Morgan
    counts) of the labelled and the regression molecules. Returns the
    kernels' errors, times and bounds."""
    import torch

    from torch.profiler import ProfilerActivity, profile

    from bbbp_tpu_torch.ops import similarity as sm
    from bbbp_tpu_torch.ops.bitops import pack_bits
    from bbbp_tpu_torch.testing import (EQUAL_F32_K, count_case,
                                        tanimoto_equal_f32_case, tanimoto_tie_case)
    from bbbp_tpu_torch.timing import (device_ms, gram_bound, gram_bound_old,
                                       host_launch_calls, topk_bound, topk_bound_old)

    aux_m, reg_m = sm.packed_bits(aux_raw[1], cuda), sm.packed_bits(reg_raw[1], cuda)
    reg_b = sm.packed_bits(reg_raw[2], cuda)              # Morgan bits, 64 words
    reg_c = sm.pack_counts(reg_raw[2], LEVELS, cuda)    # counts, 512 words
    w_m, w_b, _ = sm.ChemKernelRidge.idf_weights(reg_raw[1], reg_raw[2])
    w_m = sm.pad_weights(w_m, reg_m.shape[1] * 32, cuda)
    w_b = sm.pad_weights(w_b, reg_b.shape[1] * 32, cuda)
    n = reg_m.shape[0]
    fold = FOLD_ROWS

    def tied_queries(q, r, k, sim):
        """Queries with more references at the k-th similarity than the
        top k hold: there the tie order decides the indices."""
        full = sm.tanimoto_gram_reference(q, r)
        kth = sim[:, k - 1:k]
        return int(((full == kth).sum(1) > (sim == kth).sum(1)).sum())

    tie_q, tie_r = (sm.packed_bits(a, cuda) for a in tanimoto_tie_case(7, 60, 3000, 167))
    small_q, small_r = (sm.packed_bits(a, cuda) for a in tanimoto_tie_case(8, 33, 40, 40))
    topk_cases = [("transfer", reg_m, aux_m, 25),
                  ("fold d=167", reg_m[:fold], reg_m[fold:], 10),
                  ("fold d=2048", reg_b[:fold], reg_b[fold:], 10),
                  ("Nq=1 k=64", reg_m[:1], aux_m, 64),
                  ("Nr=1 k=1", reg_m[:17], aux_m[:1], 1),
                  ("k=Nr=40", small_q, small_r, 40),
                  ("forced ties", tie_q, tie_r, 25),
                  ("k=1024", reg_m[:9], aux_m, 1024)]
    # distinct fractions that round to one f32 at the k-th place (65,536
    # bits); k = 1, 25, 1,024 with Nr no multiple of a chunk or a split
    eq_q, eq_r = (sm.packed_bits(a, cuda) for a in tanimoto_equal_f32_case(0))
    topk_cases.append(("equal f32 d=65536", eq_q, eq_r, EQUAL_F32_K))
    for k, nr in ((1, 1031), (25, 7813), (1024, 3001)):
        q, r = (sm.packed_bits(a, cuda) for a in tanimoto_tie_case(k + nr, 37, nr, 167))
        topk_cases.append((f"k={k} Nr={nr}", q, r, k))
    # rows of 6 words, not 16-byte aligned, as a caller may pass them
    q, r = (torch.from_numpy(pack_bits(a).view(np.int32)).to(cuda)
            for a in tanimoto_tie_case(9, 37, 7813, 167))
    topk_cases.append(("6-word rows k=25 Nr=7813", q, r, 25))
    ties = {}
    k6_err = 0.0
    for name, q, r, k in topk_cases:
        sim, idx = sm.tanimoto_topk_packed(q, r, k)
        want_sim, want_idx = sm.tanimoto_topk_reference(q, r, k)
        torch.cuda.synchronize()
        k6_err = max(k6_err, float((sim - want_sim).abs().max()))
        if not (torch.equal(idx, want_idx) and torch.equal(sim, want_sim)):
            raise AssertionError(
                f"tanimoto_topk {name}: {int((idx != want_idx).sum())} indices "
                f"differ, max |dsim| {float((sim - want_sim).abs().max()):.3g}")
        if name in ("transfer", "forced ties"):
            ties[name] = (tied_queries(q, r, k, want_sim), q.shape[0])
    if min(t for t, _ in ties.values()) == 0:
        raise AssertionError(f"no ties at the k-th place to decide: {ties}")

    def held(name, fn, ref, q, r, w):
        """max |kernel - plain|: 0 demanded without weights, 1e-5 with."""
        got, want = fn(q, r, w), ref(q, r, w)
        torch.cuda.synchronize()
        err = float((got - want).abs().max()) if got.numel() else 0.0
        if (w is None and not torch.equal(got, want)) or err > 1e-5:
            raise AssertionError(f"{name} {tuple(got.shape)}: max |err| {err:.3g}")
        return err

    k7_err = k8_err = 0.0
    gram_cases = [(reg_m, reg_m, w_m), (reg_b, reg_b, w_b),
                  (reg_b[:fold], reg_b[fold:], w_b), (reg_m[:1], aux_m, w_m),
                  (reg_m[:17], aux_m[:1], w_m), (tie_q, tie_r, w_m)]
    for q, r, w in gram_cases:
        held("tanimoto_gram", sm.tanimoto_gram, sm.tanimoto_gram_reference, q, r, None)
        k7_err = max(k7_err, held("tanimoto_gram (weighted)", sm.tanimoto_gram,
                                  sm.tanimoto_gram_reference, q, r, w))
        if not torch.equal(sm.tanimoto_gram(q, r, w), sm.tanimoto_gram(q, r, w)):
            raise AssertionError(f"tanimoto_gram (weighted) {tuple(q.shape)} x "
                                 f"{tuple(r.shape)}: two runs differ")
    # unweighted at ragged shapes: rows that fill no tile, slabs padded with
    # zeros (1, 6, 7 words), rows not 16-byte aligned, clusters of 1, 2, 8
    k7_ragged = [(nq, nr, words) for nq, nr in ((1, 1), (33, 127), (127, 33),
                                                (1058, 1), (1, 1058), (127, 1058))
                 for words in (1, 6, 7, 42, 64, 2048)]
    rng_k7 = np.random.default_rng(17)
    for nq, nr, words in k7_ragged:
        q, r = (torch.from_numpy(pack_bits(rng_k7.random((n, 32 * words)) < 0.3
                                           ).view(np.int32)).to(cuda) for n in (nq, nr))
        q[0] = 0
        held("tanimoto_gram", sm.tanimoto_gram, sm.tanimoto_gram_reference, q, r, None)

    def launch_calls(fn):
        """The host's launch calls of one call of ``fn``, from the profiler."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return host_launch_calls(prof)

    calls = {"tanimoto_topk": launch_calls(lambda: sm.tanimoto_topk_packed(reg_m, aux_m, 25)),
             "tanimoto_gram": launch_calls(lambda: sm.tanimoto_gram(reg_b, reg_b)),
             "tanimoto_gram_weighted": launch_calls(lambda: sm.tanimoto_gram(reg_b, reg_b, w_b))}
    if calls["tanimoto_topk"] != 1 or calls["tanimoto_gram"] != 1:
        raise AssertionError(f"host launch calls a call {calls}: K6 and unweighted K7 "
                             f"must be one launch")

    def minmax_ref(levels):
        return lambda q, r, w: sm.minmax_gram_reference(q, r, w, levels)

    high = [sm.pack_counts(count_case(s, rows, d, 41), 8, cuda)
            for s, rows, d in ((1, 70, 2048), (2, 45, 2048), (3, 23, 30), (4, 19, 30))]
    w_c = sm.pad_weights(sm.ChemKernelRidge.idf_weights(reg_raw[1], reg_raw[2])[2],
                          reg_c.shape[1] * 4, cuda)
    count_cases = [(reg_c, reg_c, w_c, LEVELS), (reg_c[:fold], reg_c[fold:], w_c, LEVELS),
                   (reg_c[:1], reg_c, w_c, LEVELS), (high[0], high[1], w_c, 8),
                   (high[2], high[3], w_c[:high[2].shape[1] * 4].contiguous(), 8)]
    # ragged shapes: rows that fill no 64-row tile, words that fill no
    # 16-word stage or are not 16-byte aligned (42 words)
    ragged = [(nq, nr, words) for nq, nr in ((1, 1), (33, 127), (127, 33),
                                             (1058, 1), (1, 1058), (127, 1058))
              for words in (1, 42, 512)]
    rng7 = np.random.default_rng(7)
    for nq, nr, words in ragged:
        q = sm.pack_counts(count_case(nq + words, nq, 4 * words, 20), LEVELS, cuda)
        r = sm.pack_counts(count_case(nr + 2 * words, nr, 4 * words, 20), LEVELS, cuda)
        w = torch.from_numpy(rng7.uniform(0.1, 3.0, 4 * words).astype(np.float32)
                             ).to(cuda)
        count_cases.append((q, r, w, LEVELS))
    for q, r, w, levels in count_cases:
        held("minmax_gram", sm.minmax_gram, minmax_ref(levels), q, r, None)
        k8_err = max(k8_err, held("minmax_gram (weighted)", sm.minmax_gram,
                                  minmax_ref(levels), q, r, w))
        if not torch.equal(sm.minmax_gram(q, r, w), sm.minmax_gram(q, r, w)):
            raise AssertionError(f"minmax_gram (weighted) {tuple(q.shape)} x "
                                 f"{tuple(r.shape)}: two runs differ")

    # -- times: the kernel, its plain version, a library form, the bound
    def floats(words_, d):
        from bbbp_tpu_torch.ops.bitops import unpack_bits_reference
        return unpack_bits_reference(words_, d).contiguous()

    def library_tanimoto(qf, rf, k=None):
        inter = qf @ rf.T
        union = qf.sum(1)[:, None] + rf.sum(1)[None, :] - inter
        sim = inter / torch.clamp(union, min=1e-9)
        return sim if k is None else torch.topk(sim, k, dim=1)

    timed = {}
    aux_mf, reg_mf, reg_bf = floats(aux_m, 167), floats(reg_m, 167), floats(reg_b, 2048)
    k6_shapes = {"transfer": (reg_m, aux_m, reg_mf, aux_mf, 25),
                 "fold_d167": (reg_m[:fold], reg_m[fold:], reg_mf[:fold], reg_mf[fold:], 10),
                 "fold_d2048": (reg_b[:fold], reg_b[fold:], reg_bf[:fold], reg_bf[fold:], 10)}
    for name, (q, r, qf, rf, k) in k6_shapes.items():
        timed["k6", name] = {
            "ms": device_ms(lambda: sm.tanimoto_topk_packed(q, r, k)),
            "plain_ms": device_ms(lambda: sm.tanimoto_topk_reference(q, r, k)),
            "library_ms": device_ms(lambda: library_tanimoto(qf, rf, k)),
            "bound": topk_bound(q.shape[0], r.shape[0], q.shape[1], k),
            "bound_old": topk_bound_old(q.shape[0], r.shape[0], q.shape[1], k),
            "shape": f"Nq={q.shape[0]}, Nr={r.shape[0]}, d={qf.shape[1]}, k={k}"}
    # the full grams (weighted too), then a fold's fit (952²) and prediction
    # (106 x 952) grams
    k7_shapes = {"gram_d2048": (reg_b, reg_b, reg_bf, reg_bf, w_b),
                 "gram_d167": (reg_m, reg_m, reg_mf, reg_mf, w_m),
                 "fold_fit_d2048": (reg_b[fold:], reg_b[fold:], reg_bf[fold:], reg_bf[fold:], None),
                 "fold_predict_d2048": (reg_b[:fold], reg_b[fold:], reg_bf[:fold], reg_bf[fold:], None),
                 "fold_fit_d167": (reg_m[fold:], reg_m[fold:], reg_mf[fold:], reg_mf[fold:], None),
                 "fold_predict_d167": (reg_m[:fold], reg_m[fold:], reg_mf[:fold], reg_mf[fold:], None)}
    for name, (q, r, qf, rf, w) in k7_shapes.items():
        nq, nr = q.shape[0], r.shape[0]
        timed["k7", name] = {
            "ms": device_ms(lambda: sm.tanimoto_gram(q, r)),
            "plain_ms": device_ms(lambda: sm.tanimoto_gram_reference(q, r)),
            "library_ms": device_ms(lambda: library_tanimoto(qf, rf)),
            "bound": gram_bound(nq, nr, q.shape[1]),
            "bound_old": gram_bound_old(nq, nr, q.shape[1]),
            "shape": f"Nq={nq}, Nr={nr}, d={qf.shape[1]}"}
        if w is not None:
            set_terms = int((qf @ rf.T).sum().item())
            timed["k7", name].update({
                "ms_weighted": device_ms(lambda: sm.tanimoto_gram(q, r, w)),
                "plain_ms_weighted": device_ms(
                    lambda: sm.tanimoto_gram_reference(q, r, w)),
                "bound_weighted": gram_bound(nq, nr, q.shape[1], 32, set_terms)})
    counts_f = sm.unpack_counts_reference(reg_c)
    level_rows = torch.cat([(counts_f >= t).float() for t in range(1, LEVELS + 1)],
                           dim=1)                       # [n, 16 * 2048]
    row_sums = counts_f.sum(1)

    def library_minmax():
        inter = level_rows @ level_rows.T
        union = row_sums[:, None] + row_sums[None, :] - inter
        return inter / torch.clamp(union, min=1e-9)

    if not torch.equal(library_minmax(), sm.minmax_gram(reg_c, reg_c)):
        raise AssertionError("the level-stacked matmul differs from minmax_gram")
    nonzero_terms = int((level_rows[:, :2048] @ level_rows[:, :2048].T).sum().item())
    timed["k8", "gram"] = {
        "ms": device_ms(lambda: sm.minmax_gram(reg_c, reg_c)),
        "plain_ms": device_ms(lambda: sm.minmax_gram_reference(reg_c, reg_c, None,
                                                                LEVELS)),
        "library_ms": device_ms(library_minmax),
        "bound": gram_bound(n, n, reg_c.shape[1], 4),
        "ms_weighted": device_ms(lambda: sm.minmax_gram(reg_c, reg_c, w_c)),
        "plain_ms_weighted": device_ms(
            lambda: sm.minmax_gram_reference(reg_c, reg_c, w_c, LEVELS)),
        "bound_weighted": gram_bound(n, n, reg_c.shape[1], 4, nonzero_terms),
        "shape": f"Nq=Nr={n}, d=2048 counts clipped at {LEVELS}"}

    def line(t):
        return (f"{t['shape']}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f}, "
                f"library {t['library_ms']:.4f}, bound {t['bound']['bound_ms']:.5f} "
                f"({t['bound']['bound_by']})" + (
                    f", former bound {t['bound_old']['bound_ms']:.5f}"
                    if "bound_old" in t else "") + (
                    f"; weighted kernel {t['ms_weighted']:.4f}, plain "
                    f"{t['plain_ms_weighted']:.4f}, bound "
                    f"{t['bound_weighted']['bound_ms']:.5f}" if "ms_weighted" in t else ""))

    print(f"[7 similarity kernels] tanimoto_topk {len(topk_cases)} cases "
          f"({[c[0] for c in topk_cases]}): indices equal, similarities "
          f"bit-equal; queries with ties at the k-th place "
          f"{ {k: f'{a} of {b}' for k, (a, b) in ties.items()} } | tanimoto_gram "
          f"{len(gram_cases)} cases bit-equal without weights, max |err| "
          f"{k7_err:.3g} with IDF weights (limit 1e-5), weighted twice "
          f"bit-identical; {len(k7_ragged)} ragged unweighted (Nq, Nr in 1 / 33 / "
          f"127 / 1,058, words in 1 / 6 / 7 / 42 / 64 / 2,048) bit-equal | host "
          f"launch calls a call {calls} | minmax_gram "
          f"{len(count_cases)} cases (counts up to 40, clip 16 and 8; "
          f"{len(ragged)} ragged: Nq, Nr in 1 / 33 / 127 / 1,058, words in "
          f"1 / 42 / 512) bit-equal without weights, max |err| {k8_err:.3g} "
          f"with (limit 1e-5), weighted twice bit-identical | on {card}",
          flush=True)
    for (kernel, shape), t in timed.items():
        print(f"[7 similarity kernels] {kernel} {shape}: {line(t)}", flush=True)
    return {"k6_err": k6_err, "k7_err": k7_err, "k8_err": k8_err, "timed": timed,
            "launch_calls": calls}


def r2(y, pred):
    return 1.0 - float(((y - pred) ** 2).sum() / ((y - y.mean()) ** 2).sum())


def wide_fit_audit(card, aux, aux_raw):
    """Phase 8, first part: the trainer's kernels and the forest kernel on
    the transfer path's own 326-feature matrix. A deterministic
    ``GBDTClassifier`` fit on ``cuda`` is replayed on the CPU along its own
    splits (every node against the plain best split, every leaf against the
    plain leaf values), its margins come through the forest kernel and
    the plain version, and K3 and K4 are timed on its binned rows, where the
    routing is also held inside the next level's sort and inside K5."""
    import torch

    from bbbp_tpu_torch.ops.forest import dense_predict_reference, raw_predict
    from bbbp_tpu_torch.ops import forest_train as tr
    from bbbp_tpu_torch.ops.forest_train import (GBDTClassifier,
                                                 RandomForestClassifier)
    from bbbp_tpu_torch.testing import compare_gbdt_fits
    from bbbp_tpu_torch.timing import (best_splits_bound, device_ms,
                                       level_histogram_bound)
    from bbbp_tpu_torch.train.transfer import TransferConfig, _aux_feature_basis

    cfg = TransferConfig()
    labels = np.asarray(aux[1], np.float32)
    aux_x, _, _ = _aux_feature_basis(aux[0], cfg.morgan_pca_dim, device="cuda",
                                     raw=aux_raw)
    if aux_x.shape != (len(labels), WIDE_F):
        raise AssertionError(f"aux features {aux_x.shape}, expected F={WIDE_F}")
    t0 = time.time()
    fit = GBDTClassifier(n_estimators=AUDIT_TREES, learning_rate=cfg.learning_rate,
                         max_depth=cfg.depth, subsample=1.0, seed=cfg.seed,
                         device="cuda").fit(aux_x, labels)
    fit_s = time.time() - t0
    ens = fit.ensemble_
    t0 = time.time()
    audit = compare_gbdt_fits(aux_x, labels, None, ens.to_state(), task="cls",
                              lam=1.0, min_child=1.0,
                              learning_rate=cfg.learning_rate,
                              base_score=ens.base_score, tol=1e-5)
    audit_s = time.time() - t0
    n_nodes = AUDIT_TREES * ((1 << cfg.depth) - 1)
    if not audit.ok or audit.trees_compared != AUDIT_TREES or \
            audit.near_ties > 0.01 * n_nodes or audit.max_leaf_diff > 1e-4:
        raise AssertionError(f"GBDTClassifier(cuda) at F={WIDE_F} along its own "
                             f"splits: {audit}")
    t0 = time.time()
    obl_fit = GBDTClassifier(n_estimators=AUDIT_TREES, oblivious=True,
                             learning_rate=cfg.learning_rate, max_depth=cfg.depth,
                             subsample=1.0, seed=cfg.seed, device="cuda"
                             ).fit(aux_x, labels)
    obl_fit_s = time.time() - t0
    t0 = time.time()
    obl_audit = compare_gbdt_fits(aux_x, labels, None, obl_fit.ensemble_.to_state(),
                                  task="cls", lam=1.0, min_child=1.0,
                                  learning_rate=cfg.learning_rate,
                                  base_score=obl_fit.ensemble_.base_score,
                                  tol=1e-5, oblivious=True)
    obl_audit_s = time.time() - t0
    if not obl_audit.ok or obl_audit.trees_compared != AUDIT_TREES or \
            obl_audit.equal + obl_audit.equivalent + obl_audit.near_ties != n_nodes or \
            obl_audit.equal < 0.99 * n_nodes or \
            obl_audit.near_ties > 0.01 * n_nodes or obl_audit.max_leaf_diff > 1e-4:
        raise AssertionError(f"oblivious GBDTClassifier(cuda) at F={WIDE_F} along "
                             f"its own splits: {obl_audit}")
    x = torch.from_numpy(aux_x).to("cuda")
    got = raw_predict(ens, x)
    want = dense_predict_reference(ens.feat, ens.thr, ens.leaf, x, ens.depth,
                                   ens.base_score, ens.tree_scale)
    forest_err = float((got - want).abs().max())
    if forest_err > 2e-5:
        raise AssertionError(f"dense_forest on the fitted F={WIDE_F} forest: max "
                             f"|err| {forest_err:.3g}")

    # K3 and K4 timed on the path's own rows: the fit's binned matrix (167
    # of its features are MACCS bits, two bins each), the first tree's
    # gradients, and the rows' nodes under the first tree of the fit (levels
    # 0 and 5) and of a depth-10 random forest (level 9)
    xb = torch.from_numpy(fit.mapper_.transform(aux_x)).to("cuda")
    y = torch.from_numpy(labels).to("cuda")
    p0 = torch.sigmoid(torch.full_like(y, float(ens.base_score)))
    g, h = p0 - y, torch.clamp(p0 * (1 - p0), min=1e-6)
    bounds = tr.gradient_bounds(g, h)
    n_bins = torch.from_numpy(fit.mapper_.bin_counts()).to("cuda")
    tr.check_bin_counts(n_bins, xb)
    few_bins = int((n_bins <= 4).sum())
    rf = RandomForestClassifier(n_estimators=2, max_depth=cfg.rf_depth,
                                seed=cfg.seed, device="cuda").fit(aux_x, labels)
    every = torch.ones(WIDE_F, dtype=torch.bool, device="cuda")
    rows = torch.arange(len(labels), device="cuda")
    fitted, routed = {}, {"routed_sorts": 0, "routed_leaves": 0}
    for level in WIDE_LEVELS:
        trees = ens if level < cfg.depth else rf.ensemble_
        pos = torch.zeros(len(labels), dtype=torch.int64, device="cuda")
        for lv in range(level):
            node = (1 << lv) - 1 + pos
            pos = 2 * pos + (x[rows, trees.feat[0, node].long()]
                             > trees.thr[0, node]).long()
        pos, nodes = pos.int(), 1 << level
        hist = tr.level_histogram(xb, pos, g, h, nodes, bounds, n_bins,
                                  bins_checked=True)
        fixed = tr.level_histogram_fixed_reference(xb, pos, g, h, nodes, bounds)
        if not (torch.equal(hist, fixed) and torch.equal(
                tr.level_histogram(xb, pos, g, h, nodes, bounds), fixed)):
            raise AssertionError(f"level_histogram on the fit's rows, level {level}: "
                                 f"not its fixed-point plain version")
        del fixed
        # the routing on the path's rows: K3 of level + 1 given this level's
        # split, and K5 given a random split of level 5's rows into 64 leaves
        f_l, b_l, _ = tr.best_splits(hist, every, 1.0, 1.0, False)
        hold_routed_sort(tr, f"F={WIDE_F} level {level}", xb, pos, g, h, n_bins, f_l,
                         b_l, level, routed)
        if level == 5:
            hold_routed_leaves(tr, f"F={WIDE_F}", xb, pos, g, h, 64, p0.clone(), bounds,
                               np.random.default_rng(8), routed)
        index_add = index_add_call(xb, pos, g, h, nodes)
        fitted[level] = {
            "k3": device_ms(lambda: tr.level_histogram(
                xb, pos, g, h, nodes, bounds, n_bins, bins_checked=True)),
            "k3_no_bins": device_ms(lambda: tr.level_histogram(
                xb, pos, g, h, nodes, bounds)),
            "k3_plain": device_ms(lambda: tr.level_histogram_reference(
                xb, pos, g, h, nodes)),
            "k3_library": device_ms(index_add),
            "k3_bound_ms": level_histogram_bound(len(labels), WIDE_F, nodes)["bound_ms"],
            "k4": device_ms(lambda: tr.best_splits(hist, every, 1.0, 1.0, False)),
            "k4_plain": device_ms(lambda: tr.best_splits_reference(
                hist, every, 1.0, 1.0, False)),
            "k4_oblivious": device_ms(lambda: tr.best_splits(
                hist, every, 1.0, 1.0, True)),
            "k4_oblivious_plain": device_ms(lambda: tr.best_splits_reference(
                hist, every, 1.0, 1.0, True)),
            "k4_bound_ms": best_splits_bound(nodes, WIDE_F)["bound_ms"],
            "occupied_nodes": int(torch.unique(pos).numel())}

    def over_levels(key):
        return fmt([fitted[lv][key] for lv in WIDE_LEVELS])

    print(f"[8 wide fit] on the fit's own binned rows, levels {WIDE_LEVELS} "
          f"(occupied nodes {[fitted[lv]['occupied_nodes'] for lv in WIDE_LEVELS]}; "
          f"{few_bins} of {WIDE_F} features have at most 4 bins; ms): "
          f"level_histogram {over_levels('k3')} (bit-equal to its fixed-point "
          f"plain version), without n_bins {over_levels('k3_no_bins')}, plain "
          f"{over_levels('k3_plain')}, index_add_ {over_levels('k3_library')}, "
          f"bound {over_levels('k3_bound_ms')}; "
          f"best_splits {over_levels('k4')}, plain {over_levels('k4_plain')}, "
          f"oblivious {over_levels('k4_oblivious')}, plain "
          f"{over_levels('k4_oblivious_plain')}, bound "
          f"{over_levels('k4_bound_ms')} | the routing: {routed['routed_sorts']} sorts "
          f"of the next level given each level's split and {routed['routed_leaves']} K5 "
          f"call given a last split, as route_rows_reference then the plain "
          f"versions", flush=True)
    print(f"[8 wide fit] GBDTClassifier(subsample=1, {AUDIT_TREES} trees of "
          f"depth {cfg.depth}) on cuda over {aux_x.shape[0]} x {WIDE_F} aux "
          f"features: {fit_s:.3f} s; along its own splits {audit.equal} of "
          f"{n_nodes} nodes equal to the plain best split, {audit.equivalent} "
          f"equivalent, {audit.near_ties} near ties (limit 1%), max |dleaf| "
          f"{audit.max_leaf_diff:.3g} (limit 1e-4), replayed on the CPU in "
          f"{audit_s:.1f} s | the same fit oblivious: {obl_fit_s:.3f} s; "
          f"{obl_audit.equal} of {n_nodes} nodes carry the level's best summed "
          f"gain, {obl_audit.equivalent} equivalent, {obl_audit.near_ties} near "
          f"ties (limit 1%), max |dleaf| {obl_audit.max_leaf_diff:.3g}, replayed "
          f"in {obl_audit_s:.1f} s | its margins, forest kernel against plain: max "
          f"|err| {forest_err:.3g} (atol 2e-5) | on {card}", flush=True)
    return {"forest_err": forest_err, "fitted": fitted,
            "audit": {"trees": AUDIT_TREES, "nodes": n_nodes, "equal": audit.equal,
                      "equivalent": audit.equivalent,
                      "near_ties": audit.near_ties,
                      "max_leaf_diff": audit.max_leaf_diff},
            "audit_oblivious": {"trees": AUDIT_TREES, "nodes": n_nodes,
                                "equal": obl_audit.equal,
                                "equivalent": obl_audit.equivalent,
                                "near_ties": obl_audit.near_ties,
                                "max_leaf_diff": obl_audit.max_leaf_diff}}


def transfer_phase(card, counters, aux, reg, reg_raw, cache_dir):
    """Phase 8. ``aux`` and ``reg`` are (smiles, labels or target);
    ``counters`` maps a kernel's name to its wrapper. Returns the launches
    of the transfer run and of the legs."""
    import torch

    from bbbp_tpu_torch.testing import regression_legs
    from bbbp_tpu_torch.train.transfer import TransferConfig, transfer_features

    def reset():
        for fn in counters.values():
            fn.launches.reset()

    def read():
        return {name: fn.launches.count for name, fn in counters.items()}

    reg_smiles, y = reg
    cfg = TransferConfig(cache_dir=cache_dir)
    reset()
    torch.cuda.synchronize()
    t0 = time.time()
    res = transfer_features(reg_smiles, cfg, aux_data=aux, verbose=False,
                            device="cuda")
    wall = time.time() - t0
    launched = read()
    per_level = 2 * (2 * cfg.trees * cfg.depth + cfg.rf_trees * cfg.rf_depth)
    want = {"packed_project": 0, "dense_forest_predict": 6,
            "forest_level_histogram": per_level, "forest_best_splits": per_level,
            "forest_leaf_values": 2 * (2 * cfg.trees + cfg.rf_trees),
            # K9: a boosted tree's columns and the next tree's subsample (the
            # first tree's before the loop), an rf tree's weights and columns
            "forest_draws": 2 * (2 * (2 * cfg.trees + 1) + 2 * cfg.rf_trees),
            "tanimoto_topk": 2, "tanimoto_gram": 0, "minmax_gram": 0,
            "forest_level_histogram_lanes": 0,
            "forest_best_splits_lanes": 0, "forest_level_splits_lanes": 0,
            "forest_level_splits_oblivious_lanes": 0, "forest_leaf_values_lanes": 0}
    if launched != want:
        raise AssertionError(f"transfer_features launches {launched}, expected {want}")
    f = res.features
    if f.shape != (len(reg_smiles), 4) or not np.isfinite(f).all() or \
            f.min() < 0 or f.max() > 1 or res.names != [
                f"transfer_{m}" for m in cfg.models]:
        raise AssertionError(f"transfer features {f.shape} {res.names}")
    if min(res.holdout_auc.values()) <= AUC_FLOOR or set(res.holdout_auc) != set(cfg.models):
        raise AssertionError(f"holdout AUCs {res.holdout_auc}, floor {AUC_FLOOR}")
    again = transfer_features(reg_smiles, cfg, aux_data=aux, verbose=False,
                              device="cuda")
    if not np.array_equal(again.features, f) or read() != launched:
        raise AssertionError("the transfer cache file was not read back")
    on_cpu = transfer_features(
        reg_smiles, TransferConfig(models=("tknn",), cache_dir=cache_dir),
        aux_data=aux, verbose=False, device="cpu")
    tknn_err = float(np.abs(on_cpu.features[:, 0] - f[:, 3]).max())
    if tknn_err > 1e-6 or abs(on_cpu.holdout_auc["tknn"]
                              - res.holdout_auc["tknn"]) > 1e-9:
        raise AssertionError(f"transfer_tknn cuda vs cpu: max |err| {tknn_err:.3g}")
    stages = {k: round(v, 3) for k, v in res.seconds.items()}
    print(f"[8 transfer] transfer_features(cuda) {len(aux[0])} aux molecules, "
          f"{len(reg_smiles)} regression molecules, "
          f"{reg_raw[0].shape[1] + reg_raw[1].shape[1] + cfg.morgan_pca_dim} "
          f"features, models "
          f"{cfg.models} ({cfg.trees}/{cfg.trees}/{cfg.rf_trees} trees, k "
          f"{cfg.tknn_k}): {wall:.3f} s wall with the raw features cached | "
          f"stage s {stages} | launches {launched} | holdout AUC "
          f"{ {k: round(v, 4) for k, v in res.holdout_auc.items()} } (floor "
          f"{AUC_FLOOR}) | transfer_tknn cuda vs cpu max |err| {tknn_err:.3g} "
          f"(limit 1e-6) | cache file read back | on {card}", flush=True)

    # -- the regression stack's chemistry-kernel legs -----------------------
    n = len(y)

    def legs(device):
        return regression_legs(*reg_raw, y, device=device, n_folds=REG_FOLDS)

    reset()
    torch.cuda.synchronize()
    t0 = time.time()
    on_cuda = legs("cuda")
    cuda_s = time.time() - t0
    leg_launches = read()
    want = {"tanimoto_topk": REG_FOLDS, "tanimoto_gram": 6 * REG_FOLDS + 4 + 3,
            "minmax_gram": 2 * REG_FOLDS + 2 + 1}
    if {k: leg_launches[k] for k in want} != want:
        raise AssertionError(f"the legs' launches {leg_launches}, expected {want}")
    t0 = time.time()
    on_cpu = legs("cpu")
    cpu_s = time.time() - t0
    limits = {"tknn": 1e-5, "tkrr": 2e-3, "ckrr": 2e-3, "ckrr_idf": 2e-3,
              "gram_tkrr": 1e-5, "gram_ckrr": 1e-5}
    errs = {k: float(np.abs(on_cuda[k] - on_cpu[k]).max()) for k in limits}
    scores = {k: r2(y, on_cuda[k]) for k in ("tknn", "tkrr", "ckrr")}
    if any(not np.isfinite(on_cuda[k]).all() or errs[k] > limits[k] for k in limits):
        raise AssertionError(f"the legs cuda vs cpu: max |err| {errs}, limits {limits}")
    if min(scores.values()) <= 0 or on_cuda["gram_ckrr"].shape != (n, n):
        raise AssertionError(f"out-of-fold R2 of the legs {scores}")
    print(f"[8 legs] {REG_FOLDS} folds over {n} molecules (MACCS k=10 kNN, "
          f"Tanimoto ridge lam 0.1, combined-kernel ridge lam 0.06, one fold "
          f"with IDF weights, both full grams): cuda {cuda_s:.3f} s, cpu "
          f"{cpu_s:.3f} s wall | launches "
          f"{ {k: leg_launches[k] for k in want} } | out-of-fold R2 "
          f"{ {k: round(v, 4) for k, v in scores.items()} } | cuda vs cpu max "
          f"|err| { {k: float(f'{v:.3g}') for k, v in errs.items()} } (limits "
          f"{limits}) | on {card}", flush=True)
    return launched, leg_launches



def regressor_phase(card) -> dict:
    """Phase 9: the flagship regressor and its fold-batched ``train_cv``
    on the card at ``RegressionTrainConfig``'s defaults. Returns the
    model's config, the trained parameters and the inputs."""
    import torch

    from bbbp_tpu_torch.entry import entry
    from bbbp_tpu_torch.models import MultiModalRegressor
    from bbbp_tpu_torch.models.transformer_cnn import FUSIONS
    from bbbp_tpu_torch.native.bindings import fingerprints
    from bbbp_tpu_torch.testing import regression_molecules, regression_nn_inputs
    from bbbp_tpu_torch.timing import host_launch_calls, profile_summary
    from bbbp_tpu_torch.train.loop import AdamW, FoldTrainer, train_cv

    cpu, dev = torch.device("cpu"), torch.device("cuda")
    seconds = {}
    nn_fp, img, y = regression_nn_inputs(seconds=seconds)
    # regression.py's defaults: RegressionTrainConfig, PreprocessConfig (the
    # images' side, 128, is the featurizer's)
    image_size = img.shape[1]
    cfg = dict(n_layers=4, fusion="multihead", fp_tokens=1, image_size=image_size)
    folds, epochs, batch, lr, seed, snapshot_from = 10, 50, 32, 3e-4, 42, 30
    print(f"[9 images] preprocess_regression(device=\"cpu\") of {len(y)} "
          f"regression molecules (MACCS, 31 descriptors, {image_size}x"
          f"{image_size}x3 images, aux fingerprints; the Python featurizer over "
          f"{os.cpu_count()} cores): {seconds['preprocess']:.3f} s, "
          f"{seconds['bad']} dropped -> nn_fp {nn_fp.shape}, img {img.shape}",
          flush=True)
    if seconds["bad"] or not (np.isfinite(nn_fp).all() and np.isfinite(img).all()):
        raise AssertionError("the regression inputs have bad rows")

    # -- forward: the card against the CPU, the same parameters -------------
    rows = np.random.default_rng(9).choice(len(y), FWD_ROWS, replace=False)
    smiles, _ = regression_molecules()
    morgan, _ = fingerprints([smiles[i] for i in rows], "morgan", 2048)
    cases = [(dict(fusion=f, fp_tokens=t), nn_fp[rows])
             for f in FUSIONS for t in (1, 4)]
    cases.append((dict(fusion="multihead", fp_tokens=1, max_fp_width=512), morgan))
    fwd_err = {"f32": 0.0, "bf16": 0.0}
    for i, (case, fp) in enumerate(cases):
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            model = MultiModalRegressor(fp_dim=fp.shape[1], n_layers=4,
                                        image_size=image_size, dtype=dtype,
                                        generator=torch.Generator().manual_seed(i),
                                        **case)
            x = (torch.from_numpy(fp), torch.from_numpy(img[rows]))
            with torch.no_grad():
                want = model(*x)
                got = model.to(dev)(*(a.to(dev) for a in x)).cpu()
            err = float((got - want).abs().max())
            if not (torch.isfinite(got).all() and err <= FWD_TOL[name]):
                raise AssertionError(f"regressor forward {case} {name} on {dev}: "
                                     f"max |err| {err:.3g} (limit {FWD_TOL[name]})")
            fwd_err[name] = max(fwd_err[name], err)
    forward, (model, fp1, img1) = entry()
    got = forward(model, fp1, img1).cpu()
    ref = MultiModalRegressor(fp_dim=167, n_layers=4)
    ref.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    want = forward(ref, fp1.cpu(), img1.cpu())
    entry_err = float((got - want).abs().max())
    if got.shape != (8,) or entry_err > FWD_TOL["bf16"]:
        raise AssertionError(f"entry() forward {tuple(got.shape)}, max |err| "
                             f"{entry_err:.3g}")
    print(f"[9 forward] MultiModalRegressor(n_layers=4) {dev} against cpu, "
          f"{FWD_ROWS} rows, fusions {FUSIONS} x fp_tokens 1/4 at fp_dim "
          f"{nn_fp.shape[1]}, and Morgan 2048 through fp_in_proj (max_fp_width "
          f"512): max |err| f32 {fwd_err['f32']:.3g} (limit {FWD_TOL['f32']}, "
          f"TF32 off), bf16 {fwd_err['bf16']:.3g} (limit {FWD_TOL['bf16']}); "
          f"entry() bf16 {entry_err:.3g} | on {card}", flush=True)

    # -- one f32 training step of 10 folds: the card against the CPU --------
    step_cfg = dict(fp_dim=nn_fp.shape[1], dropout=0.0, dtype=torch.float32,
                    folds=folds, **cfg)
    idx = torch.from_numpy(np.random.default_rng(10).integers(
        0, len(y), (folds, batch)))
    results = []
    for d in (cpu, dev):
        model = MultiModalRegressor(generator=torch.Generator().manual_seed(11),
                                    **step_cfg).to(d)
        names = [name for name, _ in model.named_parameters()]
        params = list(model.parameters())
        opt = AdamW(params, lr, 1e-5)
        fp_b = torch.from_numpy(nn_fp)[idx].to(d)
        img_b = torch.from_numpy(img)[idx].to(d, torch.bfloat16)
        loss = ((model(fp_b, img_b, train=True) - torch.from_numpy(y)[idx].to(d))
                ** 2).mean(dim=1)
        grads = torch.autograd.grad(loss.sum(), params)
        opt.step(grads)
        results.append((loss.detach().cpu(), [g.cpu() for g in grads],
                        [p.detach().cpu() for p in params]))
        del model, params, opt, grads
    (loss0, g0, p0), (loss1, g1, p1) = results
    loss_err = float(((loss1 - loss0).abs() / loss0.abs()).max())
    grad_err, worst, p_err, p_err_all, turned = 0.0, "", 0.0, 0.0, 0
    for name, a0, a1, q0, q1 in zip(names, g0, g1, p0, p1):
        dg = (a1 - a0).abs()
        rel = float(dg.max() / a0.abs().max())
        if rel > grad_err:
            grad_err, worst = rel, name
        # where an element's gradient is ten times its difference and 100
        # times Adam's eps, its step lr·g/(|g| + eps) moves by at most
        # lr·eps/(10 |g|) = 3e-7: the parameters agree there
        diff = (q1 - q0).abs()
        steady = (dg <= 0.1 * a0.abs()) & (a0.abs() >= 1e-6)
        p_err = max(p_err, float(torch.where(steady, diff, 0.0).max()))
        p_err_all = max(p_err_all, float(diff.max()))
        turned += int((~steady).sum())
    n_params = sum(q.numel() for q in p0)
    if (loss_err > 1e-5 or grad_err > STEP_GRAD_TOL or p_err > 1e-6
            or p_err_all > STEP_TURNED * lr):
        raise AssertionError(
            f"training step {dev} vs cpu: loss rel {loss_err:.3g}, gradient "
            f"elements {grad_err:.3g} of their tensor's largest ({worst}), "
            f"parameters {p_err:.3g} where "
            f"|dg| <= |g| / 10 and |g| >= 1e-6, {p_err_all:.3g} anywhere")
    print(f"[9 step] one f32 AdamW step of {folds} folds x {batch} rows "
          f"(dropout 0, {n_params // folds:,} parameters a fold), {dev} against "
          f"cpu from the same parameters: loss rel err {loss_err:.3g} (limit "
          f"1e-5); every gradient element within {grad_err:.3g} of its "
          f"tensor's largest |g| (limit {STEP_GRAD_TOL:g}; {worst}); parameters {p_err:.3g} apart where an element's gradient "
          f"is ten times its difference and at least 1e-6 (limit 1e-6), "
          f"{p_err_all:.3g} anywhere (limit {STEP_TURNED:g} lr; {turned:,} of "
          f"{n_params:,} elements outside) | on {card}", flush=True)
    del results, p0, p1, g0, g1

    # -- one epoch, profiled; its time sets the run's epochs ----------------
    model = MultiModalRegressor(fp_dim=nn_fp.shape[1], **cfg)
    n_train = len(y) - len(y) // folds
    steps = n_train // batch
    perms = np.stack([np.random.default_rng(12 + k).permutation(len(y))[
        :steps * batch] for k in range(folds)]).reshape(folds, steps, batch)
    trainer = FoldTrainer(model, (nn_fp, img), y, folds, dev, seed, lr=lr)
    trainer.train_epoch(perms)                          # warm: cuDNN's plans
    torch.cuda.synchronize()
    t0 = time.time()
    trainer.train_epoch(perms)
    torch.cuda.synchronize()
    epoch_s = time.time() - t0
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        trainer.train_epoch(perms)
        torch.cuda.synchronize()
        prof_wall = time.time() - t0
    del trainer
    summary = profile_summary(prof, lambda name: name)
    calls = host_launch_calls(prof)
    top = sorted(summary["device"].items(), key=lambda kv: -kv[1]["ms"])[:8]
    busy = summary["device_busy_ms"]
    print(f"[9 epoch] one epoch ({steps} steps of {folds} x {batch}): "
          f"{epoch_s * 1e3:.1f} ms unprofiled; profiled {prof_wall * 1e3:.1f} ms "
          f"wall, device busy {busy:.1f} ms ({busy / 1e3 / prof_wall:.1%} of "
          f"the profiled wall, {busy / 1e3 / epoch_s:.1%} of the unprofiled), "
          f"{calls} host launch calls ({calls / steps:.0f} a step) | top device "
          f"ms: { {k[:60]: round(v['ms'], 2) for k, v in top} } | on {card}",
          flush=True)

    # -- train_cv at RegressionTrainConfig's defaults ------------------------
    run_epochs = min(epochs, max(1, int(REG_EPOCH_BUDGET_S / epoch_s)))
    if run_epochs < epochs:
        print(f"[9 train_cv] {epochs} epochs would take ~{epochs * epoch_s:.0f} s; "
              f"cut to {run_epochs}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    res = train_cv(model, (nn_fp, img), y, n_folds=folds, epochs=run_epochs,
                   batch_size=batch, lr=lr, seed=seed, split_seed=seed,
                   snapshot_from=snapshot_from, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    r2_oof = r2(y, res.oof_pred)
    if not (np.isfinite(res.oof_pred).all() and res.oof_pred.shape == y.shape
            and r2_oof > 0.3):
        raise AssertionError(f"train_cv OOF R^2 {r2_oof:.4f} (must be above 0.3)")
    print(f"[9 train_cv] MultiModalRegressor(fp_dim={nn_fp.shape[1]}, n_layers=4, "
          f"multihead, bf16) x {folds} folds on {dev}, {run_epochs} epochs of "
          f"{steps} steps, batch {batch}, lr {lr:g}, snapshots from epoch "
          f"{snapshot_from}: {wall:.3f} s wall, {wall / run_epochs * 1e3:.1f} ms "
          f"an epoch, {run_epochs * steps / wall:.1f} steps/s, peak memory "
          f"{peak / 2**30:.3f} GiB, OOF R^2 {r2_oof:.4f} (floor 0.3), last epoch's "
          f"loss a fold {fmt(res.train_losses[:, run_epochs - 1])} "
          f"| on {card}", flush=True)
    return {"model_kw": dict(cfg, fp_dim=nn_fp.shape[1]), "params": res.params,
            "fp": nn_fp, "img": img, "y": y,
            "cv_kw": dict(n_folds=folds, batch_size=batch, lr=lr, seed=seed,
                          split_seed=seed, snapshot_from=snapshot_from)}


def _near_tie_rows(d: np.ndarray, places: int) -> np.ndarray:
    """Rows of a distance matrix whose ``places`` + 1 smallest entries hold
    two distinct values within CLS_NEAR_TIE_RTOL relative."""
    srt = np.sort(np.partition(d, places, axis=1)[:, :places + 1], axis=1)
    step = np.diff(srt, axis=1)
    return ((step > 0) & (step <= CLS_NEAR_TIE_RTOL * np.maximum(srt[:, 1:], 1e-30))
            ).any(axis=1)


def _neighbour_swaps(rows: np.ndarray, kk: int, cuda) -> dict:
    """SMOTE's (kk > 0) or Tomek's (kk = 0) neighbours of ``rows`` on the
    card against the CPU, compared distance for distance on the CPU's
    distances: rows that differ, and how many of them are not near ties."""
    from bbbp_tpu_torch.ops import resample as rs

    d = rs._self_dists(rows, "cpu").numpy()
    ids = np.arange(len(rows))[:, None]
    if kk:
        on_card, on_cpu = (rs.smote_neighbors(rows, kk, dev) for dev in (cuda, "cpu"))
        differ = (np.sort(d[ids, on_card], 1) != np.sort(d[ids, on_cpu], 1)).any(1)
    else:
        on_card, on_cpu = (rs.tomek_nearest(rows, dev) for dev in (cuda, "cpu"))
        differ = d[ids[:, 0], on_card] != d[ids[:, 0], on_cpu]
    near = _near_tie_rows(d, max(kk, 1))
    return {"rows": len(rows), "differ": int(differ.sum()),
            "not_near_ties": int((differ & ~near).sum()),
            "near_tie_rows": int(near.sum())}


def classification_phase(card, counters) -> dict:
    """Phase 10: the classification ensemble (``train/classification.py``)
    over ``testing.classification_inputs()``. Returns the launches of the
    kernels in ``run_classification`` and the inputs (``x``, ``y``) with
    their projection ``z``."""
    import torch

    from bbbp_tpu_torch.ops import resample as rs
    from bbbp_tpu_torch.ops.similarity import f32_matmul
    from bbbp_tpu_torch.testing import classification_inputs
    from bbbp_tpu_torch.timing import host_launch_calls, profile_summary
    from bbbp_tpu_torch.train import batched_search as bs
    from bbbp_tpu_torch.train import classification as cl

    cuda = torch.device("cuda")
    problems = []
    t10 = time.time()
    t0 = time.time()
    x, y = classification_inputs()
    t_in = time.time() - t0
    cfg = cl.ClassificationTrainConfig(tune=False)
    t0 = time.time()
    with f32_matmul():
        z = cl._project(cl._fit_basis(x, cfg.pca_dim, cuda), x, cuda)
    print(f"[10 inputs] classification_inputs(): {x.shape[0]} molecules, MACCS "
          f"{x.shape[1]}, {y.mean():.3f} positive, {t_in:.2f} s; scaler + "
          f"PCA({cfg.pca_dim}) on cuda: {time.time() - t0:.2f} s", flush=True)

    # -- SMOTE-Tomek, card against CPU ---------------------------------------
    t0 = time.time()
    xs_g, ys_g = rs.smote_tomek(z, y, seed=cfg.seed, device=cuda)
    tomek_g = time.time() - t0
    t0 = time.time()
    xs_c, ys_c = rs.smote_tomek(z, y, seed=cfg.seed, device="cpu")
    tomek_c = time.time() - t0
    t0 = time.time()
    counts = np.bincount(y)
    minority = z[y == int(np.argmin(counts))]
    smote_swaps = _neighbour_swaps(minority, 5, cuda)
    xs_smote, _ = rs.smote(z, y, seed=cfg.seed, device="cpu")
    tomek_swaps = _neighbour_swaps(xs_smote, 0, cuda)
    same_out = xs_g.shape == xs_c.shape and np.array_equal(xs_g, xs_c) \
        and np.array_equal(ys_g, ys_c)
    rows_differ = (int((xs_g != xs_c).any(1).sum()) if xs_g.shape == xs_c.shape
                   else abs(len(xs_g) - len(xs_c)))
    for name, sw in (("SMOTE", smote_swaps), ("Tomek", tomek_swaps)):
        if sw["not_near_ties"] or sw["differ"] > CLS_NEAR_TIE_SHARE * sw["rows"]:
            problems.append(f"{name} neighbours card vs cpu: {sw}")
    if (smote_swaps["differ"] + tomek_swaps["differ"] == 0) != same_out or \
            rows_differ > CLS_NEAR_TIE_SHARE * len(xs_c):
        problems.append(f"smote_tomek card vs cpu: {rows_differ} rows differ")
    print(f"[10 smote_tomek] {len(z)} -> {len(xs_g)} rows (cpu {len(xs_c)}); "
          f"cuda {tomek_g:.2f} s, cpu {tomek_c:.2f} s; card vs cpu: output "
          f"{'bit-equal' if same_out else f'{rows_differ} rows differ'}; "
          f"SMOTE neighbours (kk 5) {smote_swaps}, Tomek nearest "
          f"{tomek_swaps} (limit: near ties only, {CLS_NEAR_TIE_SHARE:.0%} of rows; "
          f"the neighbour comparison {time.time() - t0:.1f} s)", flush=True)

    # the reference protocol's split of the resampled rows
    perm = np.random.default_rng(cfg.seed).permutation(len(ys_c))
    n_test = int(len(ys_c) * cfg.test_size)
    te, tr = perm[:n_test], perm[n_test:]
    x_tr, y_tr, x_te, y_te = xs_c[tr], ys_c[tr], xs_c[te], ys_c[te]

    # -- the non-forest estimators of default_zoo, card against CPU ----------
    from bbbp_tpu_torch.ops import metrics as mt
    from bbbp_tpu_torch.ops.linear import MLPClassifier

    zoo_g, zoo_c = cl.default_zoo(cfg.seed, cuda), cl.default_zoo(cfg.seed, "cpu")
    for zoo, dev in ((zoo_g, cuda), (zoo_c, "cpu")):
        zoo["mlp_200"] = lambda dev=dev: MLPClassifier(
            hidden=(128,), n_steps=CLS_MLP_EXACT_STEPS, seed=cfg.seed, device=dev)
    est = {}
    for m in ("knn", "logreg", "svc", "bnb", "mlp_200", "mlp"):
        tol = CLS_PROBA_TOL[m.split("_")[0]]
        t0 = time.time()
        pg = zoo_g[m]().fit(x_tr, y_tr).predict_proba(x_te)[:, 1]
        t_g = time.time() - t0
        t0 = time.time()
        pc = zoo_c[m]().fit(x_tr, y_tr).predict_proba(x_te)[:, 1]
        t_c = time.time() - t0
        err = float(np.abs(pg - pc).max())
        flips = int((((pg > 0.5) != (pc > 0.5)) & (np.abs(pc - 0.5) > tol)).sum())
        est[m] = {"max_abs_err": err, "cuda_s": round(t_g, 3), "cpu_s": round(t_c, 3)}
        if m == "mlp":                       # 800 steps: held by what it learned
            d_acc = abs(float(mt.accuracy(y_te, pg > 0.5))
                        - float(mt.accuracy(y_te, pc > 0.5)))
            d_auc = abs(float(mt.roc_auc(y_te, pg)) - float(mt.roc_auc(y_te, pc)))
            est[m].update(labels_turned=int(((pg > 0.5) != (pc > 0.5)).sum()),
                          d_accuracy=round(d_acc, 5), d_roc_auc=round(d_auc, 5))
            if d_acc > CLS_MLP_ACC_TOL or d_auc > CLS_MLP_AUC_TOL:
                problems.append(f"mlp card vs cpu: accuracy {d_acc:.4f}, ROC AUC "
                                f"{d_auc:.4f} apart")
        elif err > tol or flips:
            problems.append(f"{m} card vs cpu: max |dp| {err:.3g} (limit {tol}), "
                            f"{flips} labels turned away from 0.5")
    print(f"[10 estimators] default_zoo's non-forest models (and its MLP at "
          f"{CLS_MLP_EXACT_STEPS} steps) fit on {len(y_tr)} rows, predicting "
          f"{len(y_te)}, cuda vs cpu: {est} (limits {CLS_PROBA_TOL}; the "
          f"800-step MLP: accuracy within {CLS_MLP_ACC_TOL}, ROC AUC within "
          f"{CLS_MLP_AUC_TOL})", flush=True)

    # -- batched searches, card against CPU ----------------------------------
    searched = {}
    n_rows = len(y_tr)
    t_s = time.time()
    for m in ("logreg", "svc", "bnb", "knn", "mlp"):
        n_cpu = CLS_MLP_CPU_TRIALS if m == "mlp" else CLS_SEARCH_TRIALS
        space, default = cl.SEARCH_SPACES[m], cl.DEFAULT_TRIALS[m]
        if m == "mlp":
            space = {**space, "n_steps": CLS_MLP_EXACT_STEPS}
            default = {**default, "n_steps": CLS_MLP_EXACT_STEPS}
        kw = dict(n_iter=n_cpu, cv=cfg.search_folds, seed=cfg.seed,
                  extra_trials=[default])
        t0 = time.time()
        rg = bs.batched_random_search(m, x_tr, y_tr, space, device=cuda, **kw)
        t_g = time.time() - t0
        t0 = time.time()
        rc = bs.batched_random_search(m, x_tr, y_tr, space, device="cpu", **kw)
        t_c = time.time() - t0
        diff = max(abs(a[k] - b[k]) for a, b in zip(rg.trials, rc.trials)
                   for k in ("mean_accuracy", "mean_precision", "mean_f1"))
        searched[m] = {"trials": len(rg.trials), "cuda_s": round(t_g, 3),
                       "cpu_s": round(t_c, 3), "best": rg.best_params,
                       "best_acc": round(rg.best_score, 5),
                       "max_diff_rows": round(diff * n_rows, 2)}
        limit = (CLS_MLP_SEARCH_TOL * n_rows if m == "mlp" else CLS_ROWS_TOL) + 1e-6
        if rg.best_params != rc.best_params or diff * n_rows > limit:
            problems.append(f"{m} search card vs cpu: best {rg.best_params} vs "
                            f"{rc.best_params}, max score diff {diff * n_rows:.2f} rows")
        if m == "mlp":              # all 51 trials at 800 steps on the card, timed
            t0 = time.time()
            full = bs.batched_random_search(
                m, x_tr, y_tr, cl.SEARCH_SPACES[m], device=cuda,
                **{**kw, "n_iter": CLS_SEARCH_TRIALS,
                   "extra_trials": [cl.DEFAULT_TRIALS[m]]})
            searched[m]["cuda_s_51_trials"] = round(time.time() - t0, 3)
            searched[m]["best_of_51"] = full.best_params
    print(f"[10 searches] batched_random_search, {cfg.search_folds} folds over "
          f"{n_rows} rows, {CLS_SEARCH_TRIALS} + default trials (the MLP's "
          f"cpu comparison {CLS_MLP_CPU_TRIALS} + default at "
          f"{CLS_MLP_EXACT_STEPS} steps), cuda vs cpu: "
          f"{searched} (limit: the same best trial, {CLS_ROWS_TOL} validation rows; "
          f"the MLP's {CLS_MLP_SEARCH_TOL:.0%} of them) | {time.time() - t_s:.1f} s",
          flush=True)

    # -- run_classification(tune=False) on cuda at full width ----------------
    for c in counters.values():
        c.launches.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = cl.run_classification(cfg, x, y, verbose=False, device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: c.launches.count for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for name in ("dense_forest_predict", "forest_level_histogram",
                 "forest_best_splits", "forest_leaf_values", "forest_draws"):
        if not launches[name]:
            problems.append(f"run_classification launched no {name}")
    for m, r in res.report.items():
        print(f"[10 report] {m:9s} " + " ".join(
            f"{k} {v:.4f}" for k, v in r.items()), flush=True)
    auc = res.report["voting"]["roc_auc"]
    floor = (None if CLS_JAX_VOTING_AUC is None
             else CLS_JAX_VOTING_AUC - CLS_AUC_MARGIN)
    if floor is not None and not auc >= floor:
        problems.append(f"voting ROC AUC {auc:.4f} below {floor:.4f}")
    print(f"[10 run] run_classification(tune=False) on cuda over {len(y)} "
          f"molecules: {wall:.3f} s wall | by stage "
          f"{ {k: round(v, 3) for k, v in res.stage_s.items()} } | peak "
          f"allocated {peak:.3f} GiB | launches {launches} | voting ROC AUC "
          f"{auc:.4f} (JAX package on the CPU: {CLS_JAX_VOTING_AUC}, floor "
          f"{floor}) | on {card}", flush=True)

    # -- the forest families' search, cut to the default + 1 trial -----------
    rng = np.random.default_rng(cfg.seed)
    perm = rng.permutation(len(ys_g))
    n_test = int(len(ys_g) * cfg.test_size)
    g_tr = perm[n_test:]
    fx, fy = xs_g[g_tr], ys_g[g_tr]
    tcfg = cl.ClassificationTrainConfig(n_search_iter_forest=CLS_FOREST_TRIALS)
    torch.cuda.synchronize()
    t0 = time.time()
    _, trials, walls = cl.tune_zoo(fx, fy, bs.FOREST_FAMILIES, tcfg,
                                   verbose=False, device=cuda)
    tune_s = time.time() - t0
    fits = {m: (len(trials[m]) * tcfg.search_folds) for m in walls}
    per_fit = {m: round(walls[m] / fits[m], 3) for m in walls}
    best = {m: max(t["mean_accuracy"] for t in trials[m]) for m in trials}
    # one fold fit of xgb's default trial, profiled
    folds = bs.stratified_kfold_indices(fy, tcfg.search_folds, cfg.seed)
    prep = bs._forest_prep(fx, fy, folds, cuda)
    p = cl.DEFAULT_TRIALS["xgb"]
    p0 = float(np.clip(fy.mean(), 1e-6, 1 - 1e-6))

    def fold_fit():
        out = bs.fit_forest(
            prep["xb"], prep["edge_vals"], prep["y"], lr=p["learning_rate"],
            lam=p["reg_lambda"], min_child=1.0, subsample=p["subsample"],
            colsample=p["colsample"], base_score=float(np.log(p0 / (1 - p0))),
            seed=0, task="cls", n_trees=p["n_estimators"], depth=p["max_depth"],
            oblivious=False, rf=False, row_w=prep["w_kn"][0], n_bins=prep["n_bins"])
        torch.cuda.synchronize()
        return out

    fold_fit()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fold_fit()
        fit_wall = time.time() - t0
    fit_busy = profile_summary(prof, lambda name: name)["device_busy_ms"]
    fit_calls = host_launch_calls(prof)
    del prof
    # one MLP lane group (the default trial x 5 folds), profiled
    mlp_trial = [cl.DEFAULT_TRIALS["mlp"]]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        bs._score_param_sets("mlp", x_tr, y_tr, mlp_trial, cfg.search_folds,
                             cfg.seed, False, cuda)
        torch.cuda.synchronize()
        mlp_wall = time.time() - t0
    mlp_calls = host_launch_calls(prof)
    mlp_busy = profile_summary(prof, lambda name: name)["device_busy_ms"]
    del prof
    steps = mlp_trial[0]["n_steps"]
    print(f"[10 forest search] tune_zoo(n_search_iter_forest="
          f"{CLS_FOREST_TRIALS}) on cuda, {bs.FOREST_FAMILIES}: {tune_s:.3f} s "
          f"| s a fit {per_fit} | best CV accuracy "
          f"{ {m: round(v, 4) for m, v in best.items()} } | one fold fit of "
          f"xgb's default (300 x depth 6) profiled: {fit_wall:.3f} s wall, "
          f"device busy {fit_busy:.1f} ms ({fit_busy / 1e3 / fit_wall:.1%}), "
          f"{fit_calls} host launch calls | one MLP lane group (1 trial x "
          f"{cfg.search_folds} folds, {steps} steps) profiled: {mlp_wall:.3f} s, "
          f"busy {mlp_busy:.1f} ms ({mlp_busy / 1e3 / mlp_wall:.1%}), {mlp_calls} "
          f"host launch calls ({mlp_calls / steps:.1f} a step) | phase 10 "
          f"{time.time() - t10:.1f} s on {card}", flush=True)
    if problems:
        raise AssertionError("phase 10: " + " | ".join(problems))
    return {"launches": launches, "x": x, "y": y, "z": z, "search_x": fx,
            "search_y": fy, "forest_trials": trials, "forest_cfg": tcfg}


def _block_errors(got, want) -> dict:
    """Every array block of two ``ProcessedData``: (max |err|, the block's
    largest |value| on the CPU)."""
    out = {}
    for name in ("fp_norm", "img_norm", "desc_norm", "fp_pca", "img_pca",
                 "aux_fp_pca", "interactions"):
        a, b = getattr(got, name), getattr(want, name)
        out[name] = (float(np.abs(a - b).max()), float(np.abs(b).max()))
    return out


def _knn_near_ties(x_tr: np.ndarray, x_te: np.ndarray, k: int) -> np.ndarray:
    """Test rows whose k-th and (k+1)-th nearest training rows lie within
    1e-5 (relative) in squared distance: two correct summation orders may
    pick either."""
    d = np.sort(((x_te[:, None, :].astype(np.float64) - x_tr[None]) ** 2).sum(-1),
                axis=1)
    return np.abs(d[:, k] - d[:, k - 1]) <= 1e-5 * np.abs(d[:, k])


def _step_grad_errors(names, grads, skip=()):
    """(largest error over parameters relative to the parameter's largest
    |g|, its name) of two devices' gradients; parameters in ``skip`` are
    held relative to the largest |g| of all parameters instead."""
    top = max(float(g.abs().max()) for g in grads[0])
    worst, where = 0.0, ""
    for name, g0, g1 in zip(names, *grads):
        scale = top if any(k in name for k in skip) else float(g0.abs().max())
        rel = float((g1 - g0).abs().max()) / max(scale, 1e-30)
        if rel > worst:
            worst, where = rel, name
    return worst, where


def gnn_checks(card, smiles) -> dict:
    """Phase 11's MPNN at the graph leg's width (hidden 192, 5 layers, 128
    atoms, 10 folds): the forward on the card against the CPU from the same
    parameters, f32 (TF32 off) and bf16 as ``train_cv`` feeds it, with and
    without the fold axis; one f32 training step of 10 folds held as phase
    9 holds the regressor's."""
    import torch

    from bbbp_tpu_torch.chem.graph_features import graph_features
    from bbbp_tpu_torch.models.gnn import MPNNRegressor
    from bbbp_tpu_torch.ops.similarity import f32_matmul

    cpu, dev = torch.device("cpu"), torch.device("cuda")
    feats, _, adj_t, mask, bad = graph_features(smiles[:GNN_ROWS], max_atoms=128,
                                                edge_types=True)
    width = dict(atom_features=feats.shape[-1], hidden=192, n_layers=5)
    rng = np.random.default_rng(11)
    idx = rng.integers(0, GNN_ROWS, (REG_FOLDS, 8))
    err = {"f32": 0.0, "bf16": 0.0}
    with f32_matmul():
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            model = MPNNRegressor(**width, dtype=dtype, folds=REG_FOLDS,
                                  generator=torch.Generator().manual_seed(3))
            x = [torch.from_numpy(a) for a in (feats, adj_t)]
            x = [a.to(dtype) for a in x] + [torch.from_numpy(mask)]
            for folded in (False, True):
                xi = [a[torch.from_numpy(idx)] for a in x] if folded else x
                with torch.no_grad():
                    want = model(*xi)
                    got = model.to(dev)(*(a.to(dev) for a in xi)).cpu()
                    model.to(cpu)
                e = float((got.float() - want.float()).abs().max())
                if not (torch.isfinite(got).all() and e <= FWD_TOL[name]):
                    raise AssertionError(f"MPNN forward {name} (fold axis "
                                         f"{folded}) on cuda: max |err| {e:.3g}")
                err[name] = max(err[name], e)
        # one f32 step of 10 folds x 32 rows, dropout 0
        idx = torch.from_numpy(rng.integers(0, GNN_ROWS, (REG_FOLDS, 32)))
        y = torch.from_numpy(rng.normal(size=GNN_ROWS).astype(np.float32))
        grads, losses = [], []
        for d in (cpu, dev):
            model = MPNNRegressor(**width, dropout=0.0, dtype=torch.float32,
                                  folds=REG_FOLDS,
                                  generator=torch.Generator().manual_seed(4)).to(d)
            params = list(model.parameters())
            xb = [torch.from_numpy(a)[idx].to(d) for a in (feats, adj_t, mask)]
            loss = ((model(*xb, train=True) - y[idx].to(d)) ** 2).mean(dim=1)
            grads.append([g.cpu() for g in torch.autograd.grad(loss.sum(), params)])
            losses.append(loss.detach().cpu())
            names = [n for n, _ in model.named_parameters()]
    loss_err = float(((losses[1] - losses[0]).abs() / losses[0].abs()).max())
    grad_err, worst = _step_grad_errors(names, grads)
    if loss_err > 1e-5 or grad_err > STEP_GRAD_TOL:
        raise AssertionError(f"MPNN step on cuda vs cpu: loss rel {loss_err:.3g}, "
                             f"gradient elements {grad_err:.3g} of their "
                             f"tensor's largest ({worst})")
    print(f"[11 mpnn] MPNNRegressor(hidden 192, 5 layers, 128 atoms) x "
          f"{REG_FOLDS} folds, cuda against cpu from the same parameters on "
          f"{GNN_ROWS} molecules ({len(bad)} bad): forward max |err| f32 "
          f"{err['f32']:.3g} (limit {FWD_TOL['f32']}, TF32 off), bf16 "
          f"{err['bf16']:.3g} (limit {FWD_TOL['bf16']}), with and without the "
          f"fold axis; one f32 step of {REG_FOLDS} x 32 rows: loss rel err "
          f"{loss_err:.3g} (limit 1e-5), every gradient element within "
          f"{grad_err:.3g} of its tensor's largest |g| (limit "
          f"{STEP_GRAD_TOL:g}; {worst}) | on {card}", flush=True)
    return {"forward_err": err, "step_grad_err": grad_err}


def wide_level_holds(card, data, seed) -> dict:
    """K3 and K4 at the regression tree matrix's width on fold 0's training
    rows, binned as the fit bins them: levels 0 and 5 at the nodes of a
    GBDTRegressor's first tree (depth 6), level 9 at a random forest's
    (depth 10); held as phase 5 holds them (``hold_level``) and timed
    beside their plain versions, ``index_add_`` and their bounds."""
    import torch

    from bbbp_tpu_torch.ops import forest_train as tr
    from bbbp_tpu_torch.timing import (best_splits_bound, device_ms,
                                       level_histogram_bound)
    from bbbp_tpu_torch.train.loop import kfold_indices
    from bbbp_tpu_torch.train.regression import _tree_features_global

    xt = _tree_features_global(data, device="cuda")
    folds = kfold_indices(len(data.y), REG_FOLDS, seed)
    rows = np.concatenate(folds[1:])
    x, y = xt[rows], data.y[rows]
    n, n_feat = x.shape
    gb = tr.GBDTRegressor(n_estimators=1, max_depth=6, subsample=1.0,
                          seed=seed, device="cuda").fit(x, y)
    rf = tr.RandomForestRegressor(n_estimators=1, max_depth=10, seed=seed,
                                  device="cuda").fit(x, y)
    xd = torch.from_numpy(x).to("cuda")
    xb = torch.from_numpy(gb.mapper_.transform(x)).to("cuda")
    n_bins = torch.from_numpy(gb.mapper_.bin_counts()).to("cuda")
    yd = torch.from_numpy(y).to("cuda")
    g = torch.full_like(yd, float(gb.ensemble_.base_score)) - yd
    h = torch.ones_like(yd)
    bounds = tr.gradient_bounds(g, h)
    every = torch.ones(n_feat, dtype=torch.bool, device="cuda")
    held = {"k3_cases": 0, "k3_err": 0.0, "k3_err_plain": 0.0, "k4_near": 0,
            "k4_err": 0.0, "k4_calls": 0, "routed_sorts": 0}
    rng = np.random.default_rng(seed)
    idx = torch.arange(n, device="cuda")
    out = {}
    for level in WIDE_LEVELS:
        trees = gb.ensemble_ if level < 6 else rf.ensemble_
        pos = torch.zeros(n, dtype=torch.int64, device="cuda")
        for lv in range(level):
            node = (1 << lv) - 1 + pos
            pos = 2 * pos + (xd[idx, trees.feat[0, node].long()]
                             > trees.thr[0, node]).long()
        pos, nodes = pos.int(), 1 << level
        hold_level(tr, f"F={n_feat} level {level}", xb, pos, g, h, n_bins, nodes,
                   rng, held)
        hist = tr.level_histogram(xb, pos, g, h, nodes, bounds, n_bins,
                                  bins_checked=True)
        out[level] = {
            "k3": device_ms(lambda: tr.level_histogram(
                xb, pos, g, h, nodes, bounds, n_bins, bins_checked=True)),
            "k3_plain": device_ms(lambda: tr.level_histogram_reference(
                xb, pos, g, h, nodes)),
            "k3_library": device_ms(index_add_call(xb, pos, g, h, nodes)),
            "k3_bound": level_histogram_bound(n, n_feat, nodes)["bound_ms"],
            "k4": device_ms(lambda: tr.best_splits(hist, every, 1.0, 1.0, False)),
            "k4_plain": device_ms(lambda: tr.best_splits_reference(
                hist, every, 1.0, 1.0, False)),
            "k4_oblivious": device_ms(lambda: tr.best_splits(
                hist, every, 1.0, 1.0, True)),
            "k4_oblivious_plain": device_ms(lambda: tr.best_splits_reference(
                hist, every, 1.0, 1.0, True)),
            "k4_bound": best_splits_bound(nodes, n_feat)["bound_ms"],
            "occupied_nodes": int(torch.unique(pos).numel())}

    def over(key):
        return fmt([out[lv][key] for lv in WIDE_LEVELS])

    print(f"[11 K3/K4] fold 0's {n} training rows x {n_feat} tree features, "
          f"levels {WIDE_LEVELS} (occupied nodes "
          f"{[out[lv]['occupied_nodes'] for lv in WIDE_LEVELS]}): K3 in "
          f"{held['k3_cases']} cases bit-equal to its fixed-point plain version "
          f"(with and without n_bins), within one f32 rounding of the float64 "
          f"sums (max |err| {held['k3_err']:.3g}); K4 in {held['k4_calls']} "
          f"calls equal to the plain version but at {held['k4_near']} near-tie "
          f"nodes (largest score gap {held['k4_err']:.3g}); the next level's sort "
          f"routing each level's split in {held['routed_sorts']} cases as "
          f"route_rows_reference then the plain version | ms: level_histogram "
          f"{over('k3')}, plain {over('k3_plain')}, index_add_ "
          f"{over('k3_library')}, bound {over('k3_bound')}; best_splits "
          f"{over('k4')}, plain {over('k4_plain')}, oblivious "
          f"{over('k4_oblivious')}, plain {over('k4_oblivious_plain')}, bound "
          f"{over('k4_bound')} | on {card}", flush=True)
    return {"n_feat": n_feat, "rows": n, "levels": out, "held": held}


def regression_phase(card, counters, tmp) -> dict:
    """Phase 11: the regression stack, ``run_regression`` on the card at
    ``RegressionTrainConfig()``'s widths over a TSV of the 1,058 regression
    molecules written into ``tmp`` (its B3DB-format directory, which holds
    the run's preprocess and transfer caches too), with its checks (module
    doc)."""
    import dataclasses

    import torch

    from bbbp_tpu_torch.chem.featurize import fingerprints
    from bbbp_tpu_torch.ops.linear import KNeighborsRegressor, Ridge
    from bbbp_tpu_torch.ops.outliers import IsolationForest
    from bbbp_tpu_torch.ops.similarity import (ChemKernelRidge,
                                               TanimotoKernelRidge,
                                               TanimotoKNNRegressor)
    from bbbp_tpu_torch.pipelines.preprocess import (PreprocessConfig,
                                                     ProcessedData, cache_path,
                                                     featurize_regression,
                                                     transform_regression)
    from bbbp_tpu_torch.testing import (b3db_env, regression_molecules,
                                        write_regression_tsv)
    from bbbp_tpu_torch.train import regression as rg
    from bbbp_tpu_torch.train.loop import kfold_indices
    from bbbp_tpu_torch.train.transfer import raw_transfer_features

    problems = []
    # the artifacts (metrics, figures where matplotlib imports, the OOF
    # pickle, the NN checkpoint that phase 13 restores) beside the TSV
    cfg = rg.RegressionTrainConfig(**REG_CUTS, out_dir=os.path.join(tmp, "artifacts"))
    defaults = rg.RegressionTrainConfig()
    for key, value in REG_CUTS.items():
        print(f"[11 cut] {key} {getattr(defaults, key)} -> {value}", flush=True)
    smiles, y = regression_molecules()
    # the preprocessing config run_regression builds from cfg
    pcfg = PreprocessConfig(fp_kind=cfg.fp_kind, image_size=cfg.image_size,
                            workers=cfg.workers, seed=cfg.seed)
    tsv = os.path.join(tmp, "B3DB_regression.tsv")
    write_regression_tsv(tsv, smiles, y)

    # -- preprocessing: the card against the CPU, one featurization ------
    # every row kept, so that the isolation forest refit below sees the
    # rows the transforms' own fit saw
    every = dataclasses.replace(pcfg, logbb_min=None)
    t0 = time.time()
    feats = featurize_regression(dataclasses.replace(pcfg, tsv_path=tsv))
    t_feat = time.time() - t0
    t0 = time.time()
    on_card = transform_regression(feats, every, "cuda")
    torch.cuda.synchronize()
    t_card = time.time() - t0
    t0 = time.time()
    on_cpu = transform_regression(feats, every, "cpu")
    t_cpu = time.time() - t0
    blocks = _block_errors(on_card, on_cpu)
    for name, (e, scale) in blocks.items():
        tol = REG_SCALED_TOL if name.endswith("_norm") else REG_PROJECTED_TOL
        if not e <= tol * max(1.0, scale):
            problems.append(f"preprocess {name}: max |err| {e:.3g} (block "
                            f"scale {scale:.3g})")
    pcs = [np.concatenate([d.fp_pca, d.img_pca], axis=1)
           for d in (on_card, on_cpu)]
    iso = [IsolationForest(contamination=pcfg.contamination, seed=pcfg.seed
                           ).fit(p) for p in pcs]
    scores = [f.score_samples(p) for f, p in zip(iso, pcs)]
    d_score = float(np.abs(scores[0] - scores[1]).max())
    near = np.zeros(len(on_cpu.y), bool)
    for f, s in zip(iso, scores):
        near |= np.abs(s - f.offset_) <= max(1e-5, d_score)
    flipped = on_card.outliers != on_cpu.outliers
    if (flipped & ~near).any() or flipped.sum() > 0.01 * len(flipped):
        problems.append(f"outlier labels: {int(flipped.sum())} differ, "
                        f"{int((flipped & ~near).sum())} away from the "
                        f"threshold")
    print(f"[11 preprocess] {len(feats.y)} molecules featurized in "
          f"{t_feat:.3f} s (MACCS, 128x128 images, 31 descriptors, Morgan "
          f"counts, RDKit bits); transforms on cuda {t_card:.3f} s, on cpu "
          f"{t_cpu:.3f} s (every row, the logBB floor aside); "
          f"cuda against cpu, max |err| (block scale): "
          f"{ {k: f'{e:.3g} ({s:.3g})' for k, (e, s) in blocks.items()} } "
          f"(limits {REG_SCALED_TOL:g} standardized, {REG_PROJECTED_TOL:g} "
          f"projected, x max(1, scale)); outlier labels "
          f"{int(flipped.sum())} differ ({int(near.sum())} rows within "
          f"{max(1e-5, d_score):.3g} of a threshold; scores max |diff| "
          f"{d_score:.3g}) | on {card}", flush=True)
    del feats, on_card, on_cpu

    gnn = gnn_checks(card, smiles)

    # -- run_regression on cuda, through B3DB's TSV --------------------
    with b3db_env(tmp) as env:
        for c in counters.values():
            c.launches.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = rg.run_regression(cfg, verbose=False, device="cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {name: c.launches.count for name, c in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        data = ProcessedData.load(cache_path(pcfg, env["BBBP_PREPROCESS_CACHE"]))
        ck_desc, ck_maccs, ck_counts = raw_transfer_features(data.smiles)
    for name in ("dense_forest_predict", "forest_level_histogram",
                 "forest_best_splits", "forest_leaf_values", "forest_draws",
                 "tanimoto_topk", "tanimoto_gram", "minmax_gram"):
        if not launches[name]:
            problems.append(f"run_regression launched no {name}")
    for m, r in res.report.items():
        print(f"[11 report] {m:24s} " + " ".join(
            f"{k} {v:.4f}" for k, v in r.items()), flush=True)
    n = len(res.y)
    print(f"[11 run] run_regression(cuda) over {n} molecules (10 legs, "
          f"{cfg.n_folds} folds): {wall:.3f} s wall | by stage "
          f"{ {k: round(v, 3) for k, v in res.stage_s.items()} } | peak "
          f"allocated {peak:.3f} GiB | launches {launches} | on {card}",
          flush=True)

    # -- the deterministic legs: the cuda run against the CPU ----------------
    folds = kfold_indices(n, cfg.n_folds, cfg.seed)
    xt = rg._tree_features_global(data, device="cpu")
    bits = (fingerprints(data.smiles, kind=cfg.fp_kind).features > 0
            ).astype(np.float32)
    y = data.y
    want = {leg: np.zeros(n, np.float32) for leg in LEG_TOL}
    knn_near = np.zeros(n, bool)
    t0 = time.time()
    for i, te in enumerate(folds):
        tr_ = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        want["knn"][te] = KNeighborsRegressor(10, device="cpu").fit(
            xt[tr_], y[tr_]).predict(xt[te])
        knn_near[te] = _knn_near_ties(xt[tr_], xt[te], 10)
        want["ridge"][te] = Ridge(10.0, device="cpu").fit(
            xt[tr_], y[tr_]).predict(xt[te])
        want["tknn"][te] = TanimotoKNNRegressor(cfg.tknn_k, device="cpu").fit(
            bits[tr_], y[tr_]).predict(bits[te])
        want["tkrr"][te] = TanimotoKernelRidge(cfg.tkrr_lam, device="cpu").fit(
            bits[tr_], y[tr_]).predict(bits[te])
        want["ckrr"][te] = ChemKernelRidge(
            cfg.ckrr_lam, weights=tuple(cfg.ckrr_weights), device="cpu").fit(
            ck_maccs[tr_], ck_counts[tr_], ck_desc[tr_], y[tr_]).predict(
            ck_maccs[te], ck_counts[te], ck_desc[te])
    t_legs = time.time() - t0
    leg_err = {}
    for leg, tol in LEG_TOL.items():
        diff = np.abs(res.oof[leg] - want[leg])
        off = diff > tol
        if leg == "knn":
            leg_err["knn_near_tie_rows"] = int((off & knn_near).sum())
            off &= ~knn_near
        leg_err[leg] = float(diff.max())
        if off.any() or leg_err.get("knn_near_tie_rows", 0) > 0.01 * n:
            problems.append(f"{leg} column against cpu: max |err| "
                            f"{leg_err[leg]:.3g}, {int(off.sum())} rows beyond "
                            f"{tol:g}")
    print(f"[11 legs] the run's knn, ridge, tknn, tkrr and ckrr columns against "
          f"the same estimators on cpu over its folds ({t_legs:.3f} s): max "
          f"|err| { {k: (f'{v:.3g}' if isinstance(v, float) else v) for k, v in leg_err.items()} } "
          f"(limits {LEG_TOL}; knn rows at a near tie of the 10th neighbour "
          f"excepted, at most 1%) | on {card}", flush=True)

    wide = wide_level_holds(card, data, cfg.seed)

    # -- a learning check, not a target --------------------------------------
    stacked = res.report["stacked"]["r2"]
    legs_r2 = {leg: res.report[leg]["r2"] for leg in ("nn", "graph")}
    for leg, r in legs_r2.items():
        if not r > REG_LEG_FLOOR:
            problems.append(f"{leg} OOF R^2 {r:.4f} (floor {REG_LEG_FLOOR})")
    if REG_JAX_STACKED_R2 is not None and not (
            abs(stacked - REG_JAX_STACKED_R2) <= REG_R2_MARGIN):
        problems.append(f"stacked R^2 {stacked:.4f}, the JAX package's "
                        f"{REG_JAX_STACKED_R2} (margin {REG_R2_MARGIN})")
    print(f"[11 learning] stacked R^2 {stacked:.4f} (the JAX package on the "
          f"CPU over the same rows at the same depth: {REG_JAX_STACKED_R2}, "
          f"margin {REG_R2_MARGIN}; regression_reference.py), nn "
          f"{legs_r2['nn']:.4f}, graph {legs_r2['graph']:.4f} (floor "
          f"{REG_LEG_FLOOR}) | on {card}", flush=True)
    if problems:
        raise AssertionError("phase 11: " + " | ".join(problems))
    return {"launches": launches, "wall_s": wall, "stage_s": res.stage_s,
            "peak_gib": peak, "wide": wide, "gnn": gnn, "legs": leg_err,
            "blocks": blocks, "stacked_r2": stacked}


def family_checks(card) -> dict:
    """Phase 12, step 1: the new families' layers on the card against the
    CPU from the same parameters (module doc)."""
    import torch
    import torch.nn.functional as F

    from bbbp_tpu_torch.data.zinc import synthetic_smiles
    from bbbp_tpu_torch.models.bert import PAD, BertEncoder, SmilesTokenizer
    from bbbp_tpu_torch.models.flow import FlowModel
    from bbbp_tpu_torch.models.mlp import DualBranchMLP
    from bbbp_tpu_torch.ops.similarity import f32_matmul
    from bbbp_tpu_torch.train.bert_pretrain import mask_tokens, mlm_loss

    cpu, dev = torch.device("cpu"), torch.device("cuda")
    corpus = synthetic_smiles(400, seed=21)
    tok = SmilesTokenizer(128).fit(corpus)
    texts = corpus[:FAM_ROWS - 2] + [".".join(corpus[20:30]), ""]
    ids = torch.from_numpy(tok.encode_batch(texts))
    ids[-1] = PAD                                 # a row of PAD alone
    err, problems = {}, []

    def held(label, want, got, tol):
        scale = max(1.0, float(want.float().abs().max()))
        e = float((got.float() - want.float()).abs().max())
        err[label] = e
        if not (torch.isfinite(got).all() and e <= tol * scale):
            problems.append(f"{label}: max |err| {e:.3g} (limit {tol:g} x "
                            f"{scale:.3g})")

    with f32_matmul(), torch.no_grad():
        for mlm in (False, True):
            for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                model = BertEncoder(tok.vocab_size, d_ff=512, mlm=mlm, dtype=dtype,
                                    folds=2, generator=torch.Generator().manual_seed(5))
                want = model(ids)
                got = model.to(dev)(ids.to(dev)).cpu()
                held(f"bert_{'mlm' if mlm else 'cls'}_{name}", want, got,
                     FWD_TOL[name])
    # one f32 MLM step, dropout 0, one mask drawn on the CPU and moved
    inp, sel = mask_tokens(ids, tok.vocab_size, 0.15, torch.Generator().manual_seed(6))
    losses, grads = [], []
    with f32_matmul():
        for d in (cpu, dev):
            model = BertEncoder(tok.vocab_size, d_ff=512, mlm=True, dropout=0.0,
                                dtype=torch.float32,
                                generator=torch.Generator().manual_seed(7)).to(d)
            loss = mlm_loss(model, ids.to(d), inp.to(d), sel.to(d))
            grads.append([g.cpu() for g in torch.autograd.grad(loss, list(
                model.parameters()))])
            losses.append(float(loss.detach()))
            names = [n for n, _ in model.named_parameters()]
    mlm_loss_err = abs(losses[1] - losses[0]) / abs(losses[0])
    mlm_grad_err, worst = _step_grad_errors(names, grads, skip=(".key.bias",))
    if mlm_loss_err > 1e-5 or mlm_grad_err > STEP_GRAD_TOL:
        problems.append(f"MLM step: loss rel {mlm_loss_err:.3g}, gradient "
                        f"{mlm_grad_err:.3g} of its tensor's largest ({worst})")
    # the dual-branch MLP at the weighted ensemble's widths (MACCS 167, a
    # 128 x 128 x 3 image flat), 2 folds: eval, then train mode, whose
    # forward moves the running statistics
    rng = np.random.default_rng(8)
    fp = torch.from_numpy(rng.normal(size=(2, 32, 167)).astype(np.float32))
    img = torch.from_numpy(rng.normal(size=(2, 32, 49152)).astype(np.float32))
    stats_err = 0.0
    with f32_matmul(), torch.no_grad():
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            model = DualBranchMLP(167, 49152, dropout=0.0, dtype=dtype, folds=2,
                                  generator=torch.Generator().manual_seed(9))
            card_model = DualBranchMLP(167, 49152, dropout=0.0, dtype=dtype,
                                       folds=2, device=dev)
            card_model.load_state_dict(model.state_dict())
            for train in (False, True):
                want = model(fp, img, train=train)
                got = card_model(fp.to(dev), img.to(dev), train=train).cpu()
                held(f"mlp_{'train' if train else 'eval'}_{name}", want, got,
                     FWD_TOL[name])
            if name == "f32":
                for (k, a), (_, b) in zip(model.named_buffers(),
                                          card_model.named_buffers()):
                    stats_err = max(stats_err, float((a - b.cpu()).abs().max()))
        x = torch.from_numpy(rng.normal(size=(2, 64, 100)).astype(np.float32))
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            flow = FlowModel(100, folds=2, dtype=dtype,
                             generator=torch.Generator().manual_seed(10))
            want = flow(x)
            held(f"flow_{name}", want, flow.to(dev)(x.to(dev)).cpu(), FWD_TOL[name])
    if stats_err > FAM_STATS_TOL:
        problems.append(f"BatchNorm running statistics: max |err| {stats_err:.3g}")
    print(f"[12 layers] cuda against cpu from the same parameters: max |err| "
          f"{ {k: f'{v:.3g}' for k, v in err.items()} } (BertEncoder at 4 x 128, "
          f"vocab {tok.vocab_size}, {FAM_ROWS} rows of 128 tokens with a PAD row "
          f"and a truncated one, 2 folds, both heads; DualBranchMLP at 167 + "
          f"49,152 inputs, 2 folds x 32 rows, eval and train mode; FlowModel "
          f"100 -> 128 x 3, 2 folds x 64 rows; limits f32 {FWD_TOL['f32']}, bf16 {FWD_TOL['bf16']} "
          f"x max(1, scale), TF32 off); BatchNorm running statistics after a "
          f"train-mode forward {stats_err:.3g} (limit {FAM_STATS_TOL:g}); one "
          f"f32 MLM step on one mask: loss rel err {mlm_loss_err:.3g} (limit "
          f"1e-5), gradients {mlm_grad_err:.3g} of their tensor's largest |g| "
          f"(limit {STEP_GRAD_TOL:g}; {worst}; the key biases, 0 but for "
          f"rounding, of the largest |g| of all) | on {card}", flush=True)
    if problems:
        raise AssertionError("phase 12 layers: " + " | ".join(problems))
    return {"forward_err": err, "stats_err": stats_err,
            "mlm_loss_err": mlm_loss_err, "mlm_grad_err": mlm_grad_err}


def families_phase(card, counters, tmp, labelled, phase11_r2) -> dict:
    """Phase 12: every remaining model family on the card (module doc),
    through phase 11's B3DB-format directory ``tmp`` and its caches, with a
    classification TSV of ``labelled`` beside them."""
    import functools

    import torch

    from bbbp_tpu_torch.models.mlp import DualBranchMLP
    from bbbp_tpu_torch.pipelines.preprocess import (PreprocessConfig, ProcessedData,
                                                     cache_path)
    from bbbp_tpu_torch.testing import b3db_env, write_classification_tsv
    from bbbp_tpu_torch.train import aux_pretrain as ap
    from bbbp_tpu_torch.train import bert_pretrain as bp
    from bbbp_tpu_torch.train import regression as rg
    from bbbp_tpu_torch.train.bert_pipeline import BertTrainConfig, run_bert
    from bbbp_tpu_torch.train.flow_pipeline import FlowTrainConfig, do_flow_train
    from bbbp_tpu_torch.train.nn_search import search_nn_cv
    from bbbp_tpu_torch.train.weighted_ensemble import (WeightedEnsembleConfig,
                                                        run_weighted_ensemble)

    checks = family_checks(card)
    problems, stage_s = [], {}
    write_classification_tsv(os.path.join(tmp, "B3DB_classification.tsv"), *labelled)
    mlm = bp.MLMPretrainConfig(corpus_size=FAM_CORPUS, epochs=FAM_MLM_EPOCHS,
                               out_dir=os.path.join(tmp, "bert_pretrained"))
    defaults = bp.MLMPretrainConfig()
    print(f"[12 cut] MLM corpus_size {defaults.corpus_size} -> {FAM_CORPUS}, "
          f"epochs {defaults.epochs} -> {FAM_MLM_EPOCHS}; aux epochs "
          f"{ap.AuxPretrainConfig().epochs} -> {FAM_AUX_EPOCHS}; run_regression "
          f"at phase 11's cuts {REG_CUTS}, bert_seeds "
          f"{rg.RegressionTrainConfig().bert_seeds} -> "
          f"{FAM_BERT_CUTS['bert_seeds']}, bert_epochs "
          f"{rg.RegressionTrainConfig().bert_epochs} -> "
          f"{FAM_BERT_CUTS['bert_epochs']}; the NN search {FAM_SEARCH_TRIALS} "
          f"trials x {FAM_SEARCH_FOLDS} folds", flush=True)

    def lap(name, t0):
        torch.cuda.synchronize()
        stage_s[name] = time.time() - t0

    with b3db_env(tmp) as env:
        for c in counters.values():
            c.launches.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t_all = t0 = time.time()
        pre_dir = bp.pretrain(mlm, verbose=False, device="cuda")
        lap("mlm_pretrain", t0)
        with open(os.path.join(pre_dir, "config.json")) as f:
            mlm_cfg = json.load(f)
        aux, aux_auc = {}, {}
        for kind, epochs in FAM_AUX_EPOCHS.items():
            t0 = time.time()
            aux[kind] = ap.pretrain_aux(ap.AuxPretrainConfig(kind=kind, epochs=epochs),
                                        verbose=False, device="cuda")
            lap(f"aux_{kind}", t0)
            aux_auc[kind] = ap.load_warm_start(aux[kind])[1]
        cfg = rg.RegressionTrainConfig(
            **REG_CUTS, **FAM_BERT_CUTS, bert_leg=True, bert_pretrained_dir=pre_dir,
            graph_pretrained=aux["graph"], nn_pretrained=aux["multimodal"])
        t0 = time.time()
        res = rg.run_regression(cfg, verbose=False, device="cuda")
        lap("run_regression", t0)
        t0 = time.time()
        weighted = run_weighted_ensemble(WeightedEnsembleConfig(), verbose=False,
                                         device="cuda")
        lap("weighted_ensemble", t0)
        data = ProcessedData.load(cache_path(PreprocessConfig(
            fp_kind="maccs", image_size=128, seed=42), env["BBBP_PREPROCESS_CACHE"]))
        space = {"learning_rate": {"low": 1e-4, "high": 3e-3, "log": True},
                 "weight_decay": {"low": 1e-6, "high": 1e-3, "log": True}}
        t0 = time.time()
        search = search_nn_cv(
            functools.partial(DualBranchMLP, data.fp_norm.shape[1],
                              data.img_norm.shape[1]),
            (data.fp_norm, data.img_norm), data.y, space,
            n_iter=FAM_SEARCH_TRIALS, n_folds=FAM_SEARCH_FOLDS,
            max_replicas=FAM_SEARCH_TRIALS * FAM_SEARCH_FOLDS, seed=42,
            device="cuda")
        lap("nn_search", t0)
        t0 = time.time()
        _, bert_report, _ = run_bert(BertTrainConfig(), verbose=False, device="cuda")
        lap("run_bert", t0)
        t0 = time.time()
        _, flow_report, _ = do_flow_train(FlowTrainConfig(), verbose=False,
                                          device="cuda")
        lap("do_flow_train", t0)
        wall = time.time() - t_all
        launches = {name: c.launches.count for name, c in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for name in ("dense_forest_predict", "forest_level_histogram",
                 "forest_best_splits", "forest_leaf_values", "forest_draws"):
        if not launches[name]:
            problems.append(f"phase 12 launched no {name}")
    r2 = {leg: res.report[leg]["r2"] for leg in ("smiles", "nn", "graph", "stacked")}
    readings = [
        ("MLM loss falls", mlm_cfg["final_mlm_loss"], mlm_cfg["first_mlm_loss"],
         lambda v, f: v < f, "below the first step's"),
        ("aux graph AUC", aux_auc["graph"], FAM_AUC_FLOOR, lambda v, f: v > f, ">"),
        ("aux multimodal AUC", aux_auc["multimodal"], FAM_AUC_FLOOR,
         lambda v, f: v > f, ">"),
        ("smiles OOF R^2", r2["smiles"], FAM_SMILES_FLOOR, lambda v, f: v > f, ">"),
        ("nn OOF R^2", r2["nn"], REG_LEG_FLOOR, lambda v, f: v > f, ">"),
        ("graph OOF R^2", r2["graph"], REG_LEG_FLOOR, lambda v, f: v > f, ">"),
        ("stacked R^2", r2["stacked"], phase11_r2 - FAM_STACK_MARGIN,
         lambda v, f: v >= f, ">= phase 11's - 0.03:"),
        ("weighted ensemble R^2", weighted["ensemble"]["r2"], FAM_WEIGHTED_FLOOR,
         lambda v, f: v > f, ">"),
    ]
    # a constant BBB+ scores the test split's majority share (about 2/3,
    # testing.POSITIVE_SHARE); both pipelines split the same labels (every
    # molecule of the set parses) with the same seed and test share
    bert_cfg, flow_cfg = BertTrainConfig(), FlowTrainConfig()
    assert (bert_cfg.seed, bert_cfg.test_size) == (flow_cfg.seed, flow_cfg.test_size)
    y_all = np.asarray(labelled[1])
    te = np.random.default_rng(bert_cfg.seed).permutation(len(y_all))[
        :int(len(y_all) * bert_cfg.test_size)]
    majority = max(float(y_all[te].mean()), 1.0 - float(y_all[te].mean()))
    acc_floor = max(FAM_ACC_FLOOR, majority + FAM_ACC_MARGIN)
    for label, report in (("BERT", bert_report), ("flow", flow_report)):
        readings += [
            (f"{label} test accuracy", report["accuracy"], acc_floor,
             lambda v, f: v > f, f"> the majority share {majority:.4f} + "
             f"{FAM_ACC_MARGIN:g}, at least {FAM_ACC_FLOOR:g}:"),
            (f"{label} test ROC AUC", report["roc_auc"], FAM_CLS_AUC_FLOOR,
             lambda v, f: v > f, ">")]
    for label, value, floor, ok, how in readings:
        if not ok(value, floor):
            problems.append(f"{label} {value:.4f} (floor {how} {floor:.4f})")
    for m, r in res.report.items():
        print(f"[12 report] {m:24s} " + " ".join(
            f"{k} {v:.4f}" for k, v in r.items()), flush=True)
    print(f"[12 run] MLM pretraining over {mlm_cfg['corpus_size']} SMILES "
          f"(vocab {mlm_cfg['vocab_size']}), aux pretraining (graph over the "
          f"aux set's molecules, multimodal), run_regression(cuda) with the "
          f"SMILES leg and both warm starts over {len(res.y)} molecules "
          f"(legs {sorted(res.oof)}), run_weighted_ensemble, search_nn_cv "
          f"({FAM_SEARCH_TRIALS} trials x {FAM_SEARCH_FOLDS} folds: best "
          f"{search.best_params}, OOF R^2 {search.best_score:.4f}), run_bert, "
          f"do_flow_train: {wall:.3f} s wall | by stage "
          f"{ {k: round(v, 3) for k, v in stage_s.items()} } | run_regression "
          f"by stage { {k: round(v, 3) for k, v in res.stage_s.items()} } | "
          f"peak allocated {peak:.3f} GiB | launches {launches} | on {card}",
          flush=True)
    print("[12 learning] " + "; ".join(
        f"{label} {value:.4f} ({how} {floor:.4f})"
        for label, value, floor, _, how in readings) + f" | on {card}", flush=True)
    if problems:
        raise AssertionError("phase 12: " + " | ".join(problems))
    return {"launches": launches, "wall_s": wall, "stage_s": stage_s,
            "peak_gib": peak, "checks": checks}


def _importable(name: str) -> bool:
    import importlib

    try:
        importlib.import_module(name)
    except ImportError:
        return False
    return True


def _tree_on(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_on(v, device) for k, v in tree.items()}
    return tree.to(device)


def _flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _kernel_shap_f64(calls, x, background, n_samples, n_background=20,
                     l2=1e-3, seed=0):
    """``kernel_shap``'s phi solved in f64 from the predictions one run of
    it made (``calls``: its predict_fn's (input, output) in order): its
    coalitions and background rows are replayed from its seed, and every
    recorded input is checked against the replay. Returns (phi [n, d], the
    efficiency gaps sum(phi) - (f(x) - E[f(background)]) [n])."""
    rng = np.random.default_rng(seed)
    x = np.asarray(x, np.float32)
    bg = np.asarray(background, np.float32)
    bg = bg[rng.choice(len(bg), min(n_background, len(bg)), replace=False)]
    n, d = x.shape
    ks = np.arange(1, d)
    pk = (d - 1) / (ks * (d - ks))
    sizes = rng.choice(ks, size=n_samples, p=pk / pk.sum())
    z = np.zeros((n_samples, d))
    for i, k in enumerate(sizes):
        z[i, rng.choice(d, k, replace=False)] = 1.0
    z_full = np.concatenate([z, np.zeros((1, d)), np.ones((1, d))])
    w = np.ones(n_samples + 2)
    w[-2:] = 1e6
    if len(calls) != n + 1 or not np.array_equal(calls[0][0], bg):
        raise AssertionError("kernel SHAP's calls do not replay")
    f_bg = float(np.mean(calls[0][1].astype(np.float64)))
    design = np.concatenate([z_full, np.ones((n_samples + 2, 1))], axis=1)
    reg = l2 * np.eye(d + 1)
    reg[d, d] = 0.0
    dw = design * w[:, None]
    a = dw.T @ design + reg
    phis, gaps = np.zeros((n, d)), np.zeros(n)
    for i in range(n):
        hyb = np.where(z_full[:, None, :] == 1.0, x[i][None, None, :], bg[None, :, :])
        if not np.array_equal(calls[1 + i][0], hyb.reshape(-1, d)):
            raise AssertionError(f"kernel SHAP's hybrid rows of row {i} do not replay")
        fz = calls[1 + i][1].astype(np.float64).reshape(n_samples + 2, len(bg)).mean(1)
        phis[i] = np.linalg.solve(a, dw.T @ (fz - f_bg))[:d]
        gaps[i] = phis[i].sum() - (fz[-1] - f_bg)
    return phis, gaps


def reporting_phase(card, counters, tmp, p9, p10) -> dict:
    """Phase 13: attribution, figures, checkpoints, profiling, prefetch, the
    mesh and the dry run, and the CLIs, on the card (module doc), through
    phase 11's B3DB-format directory ``tmp``; ``p9`` and ``p10`` are phases
    9 and 10's returns. Every launch counter is set to 0 at its start and
    read at its end."""
    import contextlib
    import copy
    import io
    import pickle

    import torch
    import torch.distributed as dist

    from bbbp_tpu_torch import entry as en
    from bbbp_tpu_torch.models import MultiModalRegressor
    from bbbp_tpu_torch.ops.forest import dense_to_tree_arrays, raw_predict
    from bbbp_tpu_torch.ops.similarity import f32_matmul
    from bbbp_tpu_torch.parallel import mesh as pm
    from bbbp_tpu_torch.parallel.prefetch import prefetch_to_device
    from bbbp_tpu_torch.pipelines import analyze as an
    from bbbp_tpu_torch.pipelines import chemspace as cs
    from bbbp_tpu_torch.pipelines import featurize as fz
    from bbbp_tpu_torch.reporting.attribution import (forest_shap_values,
                                                      integrated_gradients,
                                                      kernel_shap)
    from bbbp_tpu_torch.testing import b3db_env
    from bbbp_tpu_torch.train import classification as cl
    from bbbp_tpu_torch.train.loop import train_cv
    from bbbp_tpu_torch.utils.checkpoint import restore_checkpoint
    from bbbp_tpu_torch.utils.profiling import debug_nans, trace

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    problems, stage_s = [], {}
    t13 = time.time()
    has_mpl, has_pil = _importable("matplotlib.pyplot"), _importable("PIL.Image")
    print(f"[13 env] matplotlib imports: {has_mpl}; PIL imports: {has_pil}",
          flush=True)
    for c in counters.values():
        c.launches.reset()

    def lap(name, t0):
        torch.cuda.synchronize()
        stage_s[name] = round(time.time() - t0, 3)

    # -- run_classification(tune=False, out_dir): the pipeline's files -------
    x, y, z = p10["x"], p10["y"], p10["z"]
    defaults = cl.ClassificationTrainConfig()
    models = tuple(m for m in defaults.models if m not in REP_CLS_LEFT_OUT)
    out = os.path.join(tmp, "classification")
    cfg = cl.ClassificationTrainConfig(tune=False, out_dir=out, models=models,
                                       with_learning_curves=False)
    print(f"[13 cut] run_classification(tune=False, out_dir): models "
          f"{defaults.models} -> {models} (rf's TreeSHAP, 200 trees of depth 10 "
          f"over {REP_SHAP_ROWS} rows, is minutes of host numpy), learning "
          f"curves off", flush=True)
    t0 = time.time()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cls = cl.run_classification(cfg, x, y, verbose=False, device="cuda")
    lap("run_classification", t0)
    printed = buf.getvalue()
    data_files = {"model_performance_metrics_maccs.csv", "fitted_models.pkl"}
    figures = {"performance_maccs.png", "confusion_stacking.png", "shap_gb.png",
               "shap_dependence_gb.png", "shap_kernel_mlp.png",
               "shap_kernel_dependence_mlp.png"}
    files = set(os.listdir(out))
    want_files = data_files | (figures if has_mpl else set())
    if files != want_files or "FAILED" in printed or (
            not has_mpl and "does not import" not in printed):
        problems.append(f"run_classification(out_dir) wrote {sorted(files)}, "
                        f"expected {sorted(want_files)}; printed {printed!r}")
    with open(os.path.join(out, "fitted_models.pkl"), "rb") as f:
        fitted = pickle.load(f)

    # -- TreeSHAP: additivity against the forest kernel's margin ------------
    t0 = time.time()
    est = fitted[REP_SHAP_FOREST]
    rows = z[np.random.default_rng(0).choice(len(z), REP_SHAP_ROWS, replace=False)]
    phi = forest_shap_values(est, rows, max_samples=None)
    ens = est.ensemble_
    trees = dense_to_tree_arrays(ens, rows)
    base = ens.base_score + ens.tree_scale * sum(
        float((t.value.astype(np.float64) * t.cover)[t.feature < 0].sum() / t.cover[0])
        for t in trees)
    margin = raw_predict(ens, torch.from_numpy(rows).to(cuda)).cpu().numpy()
    add_err = np.abs(base + phi.sum(1) - margin) / np.maximum(1.0, np.abs(margin))
    if not add_err.max() <= REP_ADDITIVITY_TOL:
        problems.append(f"TreeSHAP additivity {add_err.max():.3g} of max(1, |margin|)")
    lap("tree_shap", t0)

    # -- kernel SHAP of the MLP: the card against the CPU -------------------
    t0 = time.time()
    mlp = fitted["mlp"]
    mlp_cpu = copy.copy(mlp)
    mlp_cpu.params_ = [(w.cpu(), b.cpu()) for w, b in mlp.params_]
    kx = rows[:REP_KSHAP_ROWS]
    phis, calls = {}, {}
    for name, m in (("cuda", mlp), ("cpu", mlp_cpu)):
        calls[name] = []

        def predict(a, m=m, seen=calls[name]):
            p = m.predict_proba(a)[:, 1]
            seen.append((np.array(a, copy=True), np.array(p, copy=True)))
            return p

        phis[name] = kernel_shap(predict, kx, z, n_samples=REP_KSHAP_SAMPLES)
    phi64 = {name: _kernel_shap_f64(calls[name], kx, z, REP_KSHAP_SAMPLES)
             for name in calls}
    kshap_err = float(np.abs(phi64["cuda"][0] - phi64["cpu"][0]).max())
    eff_err = float(np.abs(phi64["cuda"][1]).max())
    kshap32_err = float(np.abs(phis["cuda"] - phis["cpu"]).max())
    solve32_err = float(np.abs(phis["cuda"] - phi64["cuda"][0]).max())
    phi_max = float(np.abs(phi64["cuda"][0]).max())
    phi_median = float(np.median(np.abs(phi64["cuda"][0])))
    pred_err = max([float(np.abs(mlp.predict_proba(z) - mlp_cpu.predict_proba(z)).max())]
                   + [float(np.abs(a[1] - b[1]).max())
                      for a, b in zip(calls["cuda"], calls["cpu"])])
    if not (kshap_err <= REP_KSHAP_TOL and eff_err <= REP_EFFICIENCY_TOL
            and pred_err <= REP_PRED_TOL):
        problems.append(f"kernel SHAP (f64 solve): card vs CPU {kshap_err:.3g} "
                        f"(limit {REP_KSHAP_TOL}; |phi| up to {phi_max:.3g}), "
                        f"efficiency {eff_err:.3g} (limit {REP_EFFICIENCY_TOL}); "
                        f"the MLP's predictions card vs CPU {pred_err:.3g} "
                        f"(limit {REP_PRED_TOL})")
    lap("kernel_shap", t0)

    # -- integrated gradients of phase 9's regressor (fold 0, f32) ----------
    t0 = time.time()
    nets = {}
    for name, dev in (("cuda", cuda), ("cpu", cpu)):
        net = MultiModalRegressor(**p9["model_kw"], dtype=torch.float32, device=dev)
        with torch.no_grad():
            for pname, value in p9["params"].items():
                net.get_parameter(pname).copy_(value[0:1])
        nets[name] = net
    fp = torch.from_numpy(np.asarray(p9["fp"][:REP_IG_ROWS + 1], np.float32))
    img = torch.from_numpy(np.asarray(p9["img"][:REP_IG_ROWS + 1], np.float32))
    ig = {}
    with f32_matmul():
        for name, dev in (("cuda", cuda), ("cpu", cpu)):
            f, i = fp.to(dev), img.to(dev)
            xs = (f[:REP_IG_ROWS], i[:REP_IG_ROWS])
            base_in = (f[REP_IG_ROWS:].expand_as(xs[0]).contiguous(),
                       i[REP_IG_ROWS:].expand_as(xs[1]).contiguous())
            net = nets[name]
            ig[name] = [a.detach().cpu() for a in integrated_gradients(
                lambda v, net=net: net(v[0], v[1]), xs, baseline=base_in,
                steps=REP_IG_STEPS)]
            if name == "cuda":
                with torch.no_grad():
                    delta = (net(*xs) - net(*base_in)).cpu()
                long = integrated_gradients(lambda v, net=net: net(v[0], v[1]), xs,
                                            baseline=base_in, steps=4 * REP_IG_STEPS)
                gap256 = float((sum(a.flatten(1).sum(1) for a in long).cpu()
                                - delta).abs().max())
    ig_err = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                 for a, b in zip(ig["cuda"], ig["cpu"]))
    gap = float((sum(a.flatten(1).sum(1) for a in ig["cuda"]) - delta).abs().max())
    scale_f = float(delta.abs().max())
    if not (ig_err <= REP_IG_TOL and gap <= REP_IG_COMPLETENESS * max(scale_f, 1e-6)):
        problems.append(f"integrated gradients: card vs CPU {ig_err:.3g} of scale "
                        f"(limit {REP_IG_TOL}); completeness gap {gap:.3g} of "
                        f"|f(x) - f(b)| up to {scale_f:.3g} (limit "
                        f"{REP_IG_COMPLETENESS} of it)")
    lap("integrated_gradients", t0)

    # -- phase 11's NN checkpoint, restored onto the card --------------------
    t0 = time.time()
    ck_path = os.path.join(tmp, "artifacts", "nn_checkpoint")
    ref = restore_checkpoint(ck_path)
    on_card = restore_checkpoint(ck_path, _tree_on(ref, cuda))
    ref_leaves, card_leaves = dict(_flat_leaves(ref)), dict(_flat_leaves(on_card))
    ck_equal = set(ref_leaves) == set(card_leaves) and all(
        v.is_cuda and v.dtype == ref_leaves[k].dtype
        and torch.equal(v.cpu(), ref_leaves[k]) for k, v in card_leaves.items())
    if not ck_equal or not ref_leaves:
        problems.append("the NN checkpoint did not restore bit-equal onto the card")
    lap("checkpoint", t0)

    # -- prefetch, trace, debug_nans ----------------------------------------
    t0 = time.time()
    items = [np.full((1 << 18,), i, np.float32) for i in range(REP_PREFETCH_ITEMS)]
    sums = [float((t * 2).sum()) for t in prefetch_to_device(iter(items), depth=2)]
    prefetch_ok = sums == [2.0 * i * (1 << 18) for i in range(REP_PREFETCH_ITEMS)]
    log_dir = os.path.join(tmp, "trace")
    net = nets["cuda"]
    with trace(log_dir) as prof:
        out_t = net(fp[:REP_IG_ROWS].to(cuda), img[:REP_IG_ROWS].to(cuda))
        torch.autograd.grad(out_t.sum(), list(net.parameters()))
        torch.cuda.synchronize()
    device_us = sum(getattr(e, "device_time_total", 0.0) or 0.0
                    for e in prof.key_averages())
    traced = os.listdir(log_dir)
    nan_fwd = nan_bwd = False
    with debug_nans():
        try:
            torch.log(torch.tensor([-1.0, 1.0], device=cuda))
        except FloatingPointError:
            nan_fwd = True
        xg = torch.tensor([0.0, 4.0], device=cuda, requires_grad=True)
        yg = (torch.sqrt(xg) * 0.0).sum()
        try:
            yg.backward()
        except FloatingPointError:
            nan_bwd = True
    if not (prefetch_ok and len(traced) == 1 and device_us > 0 and nan_fwd and nan_bwd):
        problems.append(f"prefetch in order {prefetch_ok}; trace files {traced}, "
                        f"device us {device_us:.1f}; debug_nans raised forward "
                        f"{nan_fwd}, backward {nan_bwd}")
    lap("prefetch_trace_nans", t0)

    # -- train_cv over a 1 x 1 mesh on NCCL: phase 9's model and inputs ------
    t0 = time.time()
    mesh_kw = dict(p9["cv_kw"], epochs=REP_MESH_EPOCHS, snapshot_from=REP_MESH_EPOCHS)
    print(f"[13 cut] train_cv over a 1 x 1 NCCL mesh: phase 9's "
          f"MultiModalRegressor({p9['model_kw']}), {len(p9['y'])} rows, "
          f"{p9['cv_kw']} -> epochs {REP_MESH_EPOCHS}, snapshot_from "
          f"{mesh_kw['snapshot_from']}", flush=True)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    pm.init_local_group("nccl", 0, 1, pm.free_port())
    try:
        runs = [train_cv(MultiModalRegressor(**p9["model_kw"]), (p9["fp"], p9["img"]),
                         p9["y"], device="cuda", mesh=mesh, **mesh_kw)
                for mesh in (pm.make_mesh(1), None)]
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic = det
    mesh_equal = (np.array_equal(runs[0].oof_pred, runs[1].oof_pred)
                  and np.array_equal(runs[0].train_losses, runs[1].train_losses)
                  and set(runs[0].params) == set(runs[1].params)
                  and all(torch.equal(runs[0].params[k], runs[1].params[k])
                          for k in runs[1].params))
    mesh_r2 = r2(p9["y"], runs[0].oof_pred)
    if not (mesh_equal and np.isfinite(runs[0].oof_pred).all()):
        problems.append("train_cv over a 1 x 1 NCCL mesh is not bit-equal to the "
                        "run without a mesh")
    del runs
    lap("train_cv_mesh", t0)

    # -- the dry run: 4 gloo processes on the CPU ---------------------------
    t0 = time.time()
    dry = en.dryrun_multichip(4)
    want_loss, want = en.dryrun_step(2, device="cpu")
    dry_loss_err = float(np.abs(dry["loss"] - want_loss).max())
    flips = sum(int((np.abs(v - want[k]) > REP_DRYRUN_TOL).sum())
                for k, v in dry["params"].items())
    total = sum(v.size for v in want.values())
    worst = max(float(np.abs(v - want[k]).max()) for k, v in dry["params"].items())
    f32_loss, f32_params = pm.launch(en.dryrun_rank, 4, 4, None, None,
                                     torch.float32)[0]
    f32_want_loss, f32_want = en.dryrun_step(2, dtype=torch.float32, device="cpu")
    f32_err = max([float(np.abs(f32_loss - f32_want_loss).max())] + [
        float(np.abs(v - f32_want[k]).max()) for k, v in f32_params.items()])
    if not (dry["backend"] == "gloo" and dry_loss_err <= REP_DRYRUN_TOL
            and worst <= 2 * en.DRYRUN_LR + REP_DRYRUN_TOL
            and flips <= REP_DRYRUN_FLIPS * total and f32_err <= REP_DRYRUN_TOL):
        problems.append(f"dry run: bf16 losses {dry_loss_err:.3g}, params worst "
                        f"{worst:.3g} with {flips} of {total} beyond "
                        f"{REP_DRYRUN_TOL}; f32 {f32_err:.3g}")
    lap("dryrun", t0)

    # -- the CLIs over phase 11's directory ----------------------------------
    t0 = time.time()
    cli_dir = os.path.join(tmp, "cli")
    saved_argv = sys.argv
    with b3db_env(tmp):
        try:
            sys.argv = ["featurize", "b3db", "--dataset", "regression", "--kinds",
                        "morgan", "maccs", "rdkit", "pairs", "--out-dir",
                        os.path.join(cli_dir, "featurize")]
            fz.main()
            sys.argv = ["analyze", "--dataset", "regression", "--out-dir",
                        os.path.join(cli_dir, "analyze"), "--device", "cuda"]
            a_card = an.main()
            sys.argv = ["chemspace", "--mode", "regression", "--out-dir",
                        os.path.join(cli_dir, "chemspace"), "--device", "cuda"]
            c_card = cs.main()
        finally:
            sys.argv = saved_argv
        with contextlib.redirect_stdout(io.StringIO()):
            a_cpu = an.analyze("regression", os.path.join(cli_dir, "a_cpu"),
                               device="cpu")
            c_cpu = cs.regression_space(os.path.join(cli_dir, "c_cpu"), device="cpu")
    npys = sorted(f for f in os.listdir(os.path.join(cli_dir, "featurize"))
                  if f.endswith(".npy"))
    shapes = {f: np.load(os.path.join(cli_dir, "featurize", f)).shape for f in npys}
    pca = {name: [a["coords"]] + [c["coords"][k] for k in sorted(c["coords"])]
           for name, a, c in (("cuda", a_card, c_card), ("cpu", a_cpu, c_cpu))}
    pca_err = max(float(np.abs(g - w).max()) / max(1.0, float(np.abs(w).max()))
                  for g, w in zip(pca["cuda"], pca["cpu"]))
    if len(npys) != 4 or pca_err > REP_PCA_TOL:
        problems.append(f"CLIs: featurize wrote {npys}; PCA coordinates card vs "
                        f"CPU {pca_err:.3g} of scale (limit {REP_PCA_TOL})")
    lap("clis", t0)

    launches = {name: c.launches.count for name, c in counters.items()}
    wall = time.time() - t13
    if launches["dense_forest_predict"] == 0:
        problems.append("the forest kernel's counter did not move in phase 13")
    print(f"[13 pipelines] run_classification(tune=False, out_dir) on cuda: "
          f"{cls.wall_time_s:.3f} s, wrote {sorted(files)} (figures: {has_mpl}); "
          f"by stage {cls.stage_s} | on {card}", flush=True)
    print(f"[13 attribution] TreeSHAP of {REP_SHAP_FOREST} ({ens.leaf.shape[0]} "
          f"trees of depth {ens.depth}) over {REP_SHAP_ROWS} rows: additivity "
          f"against the forest kernel's margin max {add_err.max():.3g} of max(1, "
          f"|margin|) (limit {REP_ADDITIVITY_TOL}); the MLP's predictions over "
          f"{len(z)} rows card vs CPU {pred_err:.3g} (limit {REP_PRED_TOL}); "
          f"kernel SHAP of the MLP over {REP_KSHAP_ROWS} rows (|phi| up to "
          f"{phi_max:.3g}, median {phi_median:.3g}): phi solved in f64 from "
          f"each device's predictions card vs CPU {kshap_err:.3g} (limit "
          f"{REP_KSHAP_TOL}), efficiency {eff_err:.3g} (limit "
          f"{REP_EFFICIENCY_TOL}); the f32 solve's phi card vs CPU "
          f"{kshap32_err:.3g}, against its f64 solve {solve32_err:.3g} (its own "
          f"rounding: not held); integrated gradients of phase 9's regressor "
          f"(fold 0, f32, {REP_IG_ROWS} rows, {REP_IG_STEPS} steps, baseline "
          f"another molecule): card vs CPU {ig_err:.3g} of scale (limit "
          f"{REP_IG_TOL}), completeness gap {gap:.3g} of |f(x) - f(b)| up to "
          f"{scale_f:.3g} (limit {REP_IG_COMPLETENESS} of it; "
          f"{4 * REP_IG_STEPS} steps: {gap256:.3g}) | on {card}", flush=True)
    print(f"[13 utilities] nn_checkpoint: {len(ref_leaves)} leaves restored onto "
          f"cuda bit-equal {ck_equal}; prefetch_to_device({REP_PREFETCH_ITEMS} "
          f"items of 1 MiB) in order {prefetch_ok}; trace: {traced}, device "
          f"{device_us / 1e3:.3f} ms; debug_nans raised on the card forward "
          f"{nan_fwd}, backward {nan_bwd}; train_cv of phase 9's regressor "
          f"({mesh_kw['n_folds']} folds, {REP_MESH_EPOCHS} epochs) over a 1 x 1 "
          f"NCCL mesh bit-equal {mesh_equal} (OOF R^2 {mesh_r2:.4f}); dryrun_multichip(4) on {dry['backend']}: "
          f"mesh {dry['mesh']}, losses {np.round(dry['loss'], 6).tolist()}, "
          f"against one unsharded step: losses {dry_loss_err:.3g}, params worst "
          f"{worst:.3g} ({flips} of {total} elements beyond {REP_DRYRUN_TOL}: a "
          f"first AdamW step's sign at a bf16 rounding; limit "
          f"{REP_DRYRUN_FLIPS:.1%}), f32 {f32_err:.3g} (limit {REP_DRYRUN_TOL}) "
          f"| on {card}", flush=True)
    print(f"[13 clis] featurize b3db (regression): {shapes}; analyze and "
          f"chemspace --device cuda: PCA coordinates card vs CPU {pca_err:.3g} "
          f"of scale (limit {REP_PCA_TOL}) | phase 13 {wall:.1f} s by stage "
          f"{stage_s} | launches {launches} | on {card}", flush=True)
    if problems:
        raise AssertionError("phase 13: " + " | ".join(problems))
    return {"launches": launches, "wall_s": wall, "stage_s": stage_s}


def lanes_phase(card, counters, p10) -> dict:
    """Phase 14: the lane-batched forest search (``_forest_cv_vmapped``
    over ``fit_forest_lanes``) on phase 10's search matrix. Returns the
    lane kernels' numbers for the kernels line."""
    import torch

    from bbbp_tpu_torch.ops import forest_train as tr
    from bbbp_tpu_torch.timing import (best_splits_bound, device_ms,
                                       host_launch_calls, leaf_values_bound,
                                       level_histogram_bound, level_splits_bound,
                                       profile_summary)
    from bbbp_tpu_torch.testing import eager_tree_loop
    from bbbp_tpu_torch.train import batched_search as bs
    from bbbp_tpu_torch.train import classification as cl

    cuda = torch.device("cuda")
    t14 = time.time()
    problems = []
    fx, fy, tcfg = p10["search_x"], p10["search_y"], p10["forest_cfg"]
    seq_trials = p10["forest_trials"]
    lane_names = ("forest_level_splits_lanes", "forest_level_splits_oblivious_lanes",
                  "forest_leaf_values_lanes")
    # K3 and K4 with lanes: the fused searches' yardstick, and an oblivious
    # tree's levels past oblivious_fused_levels (cat's search's, at its lanes)
    two_kernels = ("forest_level_histogram_lanes", "forest_best_splits_lanes")
    single_names = ("forest_level_histogram", "forest_best_splits",
                    "forest_leaf_values", "dense_forest_predict")

    def reset():
        for c in counters.values():
            c.launches.reset()

    def read():
        return {name: c.launches.count for name, c in counters.items()}

    def trial_params(t):
        return {k: v for k, v in t.items()
                if not k.startswith("mean_") and k != "repeat_std"}

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count

    def oblivious_split(counts, lanes, depth) -> str:
        """'' where an oblivious lane group's launches are the cut-over's:
        the fused oblivious search at each tree's first
        ``oblivious_fused_levels`` levels, K3 then K4 with lanes at the
        others, the per-node search never; else what differs."""
        fused = min(depth, tr.oblivious_fused_levels(lanes, fx.shape[1], sms))
        obl = counts.get("forest_level_splits_oblivious_lanes", 0)
        k3, k4 = (counts.get(k, 0) for k in two_kernels)
        if (k3 == k4 and bool(obl) == (fused > 0) and bool(k3) == (fused < depth)
                and obl * (depth - fused) == k3 * fused
                and not counts.get("forest_level_splits_lanes", 0)):
            return ""
        return (f"{lanes} oblivious lanes of depth {depth}: the fused oblivious search "
                f"{obl}, K3 / K4 with lanes {k3} / {k4}, the per-node search "
                f"{counts.get('forest_level_splits_lanes', 0)} launches, the fused search "
                f"due at {fused} levels")

    cat_depths = {int(trial_params(t).get("max_depth", 6)) for t in seq_trials["cat"]}
    cat_lanes = len(seq_trials["cat"]) * tcfg.search_folds
    cat_depth = max(cat_depths)
    cat_fused = min(cat_depth, tr.oblivious_fused_levels(cat_lanes, fx.shape[1], sms))

    def searched_group(m):
        """m's tuned search with the lanes (``LANES_GROUP_TRIALS`` + the
        default trial, 5 folds): wall s, peak memory, launches and the
        blocks of lanes it cut each static shape into; then the whole search
        once more under ``torch.profiler`` (each tree after a group's first
        is one replay of its graph): device busy ms, host launch calls a
        tree step (a tree of one group of lanes), and the ``torch.Generator``
        draws among them, which K9 has replaced (0)."""
        kw = dict(n_iter=LANES_GROUP_TRIALS, cv=tcfg.search_folds, seed=tcfg.seed,
                  extra_trials=[cl.DEFAULT_TRIALS[m]], device=cuda)
        reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()     # the earlier phases' tensors
        t0 = time.time()
        group = bs.batched_random_search(m, fx, fy, cl.SEARCH_SPACES[m], **kw)
        torch.cuda.synchronize()
        out = {"group": group, "wall_s": time.time() - t0,
               "peak_gib_above_live": (torch.cuda.max_memory_allocated() - live) / 2 ** 30,
               "live_gib": live / 2 ** 30,
               "launches": {k: v for k, v in read().items() if v}}
        params = [trial_params(t) for t in group.trials]
        n_rows, n_cols = len(fy), np.asarray(fx).shape[1]
        out["lane_blocks"] = {
            f"T={n_est} depth {depth}": [len(t_ids) * tcfg.search_folds, -(
                -len(t_ids) * tcfg.search_folds
                // bs.lane_block(n_rows, n_cols, depth, n_est, obl))]
            for (_, n_est, depth, obl), t_ids in bs._forest_groups(params).items()}
        out["tree_steps"] = sum(n_est for _, n_est, _, _ in bs._forest_groups(params))
        shapes = bs._forest_groups(params)
        if m == "cat" and len(shapes) == 1:         # the cut-over at the group's lanes
            (_, n_est, depth, _), t_ids = next(iter(shapes.items()))
            off = oblivious_split(out["launches"], len(t_ids) * tcfg.search_folds, depth)
            if off:
                problems.append(f"cat's group: {off}")
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            bs._score_param_sets(m, fx, fy, params, tcfg.search_folds, tcfg.seed,
                                 False, cuda)
            torch.cuda.synchronize()
            out["profiled_s"] = time.time() - t0
        t0 = time.time()
        out["busy_ms"] = profile_summary(prof, lambda name: name)["device_busy_ms"]
        out["host_launch_calls"] = host_launch_calls(prof)
        out["generator_draws"] = sum(e.count for e in prof.key_averages()
                                     if e.key in ("aten::rand", "aten::poisson"))
        out["profiler_post_s"] = time.time() - t0
        calls_a_step = out["host_launch_calls"] / out["tree_steps"]
        if calls_a_step > MAX_CALLS_A_TREE or out["generator_draws"]:
            problems.append(f"{m}'s group: {calls_a_step:.2f} host launch calls a tree "
                            f"step (limit {MAX_CALLS_A_TREE}), {out['generator_draws']} "
                            f"torch.Generator draws")
        return out

    stage_s = {}
    t_stage = time.time()
    vmap_before = bs.FOREST_VMAP
    bs.FOREST_VMAP = True
    try:
        # -- the five families' searches through tune_zoo, on the lanes, family
        # by family: the fused oblivious search in cat's only, K3 and K4 with
        # lanes in none ------------------------------------------------------
        lane_trials, lane_walls, family_launches = {}, {}, {}
        search_s = 0.0
        for m in bs.FOREST_FAMILIES:
            reset()
            torch.cuda.synchronize()
            t0 = time.time()
            _, trials_m, walls_m = cl.tune_zoo(fx, fy, (m,), tcfg, verbose=False,
                                               device=cuda)
            torch.cuda.synchronize()
            search_s += time.time() - t0
            family_launches[m] = read()
            lane_trials.update(trials_m)
            lane_walls.update(walls_m)
            fused = family_launches[m]["forest_level_splits_lanes"]
            obl = family_launches[m]["forest_level_splits_oblivious_lanes"]
            two = [family_launches[m][name] for name in two_kernels]
            if m == "cat":
                off = ("" if len(cat_depths) == 1 else f"depths {sorted(cat_depths)}") or \
                    oblivious_split(family_launches[m], cat_lanes, cat_depth)
                if off:
                    problems.append(f"cat lane search: {off}")
            elif not fused or obl or any(two):
                problems.append(f"{m} lane search: fused {fused}, oblivious {obl}, K3 / K4 "
                                f"with lanes {two} launches")
        launches = {name: sum(f[name] for f in family_launches.values())
                    for name in counters}
        for name in ("forest_level_splits_lanes", "forest_leaf_values_lanes",
                     "forest_draws") + (lane_names[1:2] if cat_fused else two_kernels):
            if not launches[name]:
                problems.append(f"the lane search launched no {name}")
        for name in single_names:
            if launches[name]:
                problems.append(f"the lane search launched {name}")
        scores = {}
        for m in bs.FOREST_FAMILIES:
            a = np.array([t["mean_accuracy"] for t in seq_trials[m]])
            b = np.array([t["mean_accuracy"] for t in lane_trials[m]])
            same = ([trial_params(t) for t in seq_trials[m]]
                    == [trial_params(t) for t in lane_trials[m]])
            diff = float(np.abs(a - b).max())
            scores[m] = {"trials": len(a), "equal": int((a == b).sum()),
                         "max_diff": round(diff, 6),
                         "max_diff_rows": round(diff * len(fy), 2),
                         "lane_s": round(lane_walls[m], 3)}
            if not same or diff > LANES_SCORE_TOL:
                problems.append(f"{m} lane search vs sequential: trials "
                                f"{'equal' if same else 'differ'}, max |dacc| {diff:.4g}")

        # -- fold 0 of every trial: a lane of its group against fit_forest ----
        folds = bs.stratified_kfold_indices(fy, tcfg.search_folds, tcfg.seed)
        prep = bs._forest_prep(fx, fy, folds, cuda)
        base = bs._forest_base(np.asarray(fy, np.float32), True)
        n_folds = len(folds)
        checked = groups_eager = 0
        for m in bs.FOREST_FAMILIES:
            params = [trial_params(t) for t in lane_trials[m]]
            for t_ids in bs._forest_groups(params).values():
                blk = [(t, k) for t in t_ids for k in range(n_folds)]
                lanes = bs._fit_lane_block(prep, params, blk, base)
                with eager_tree_loop():
                    eager = bs._fit_lane_block(prep, params, blk, base)
                for name, a, b in zip(("margins", "feats", "thrs", "leaves"), lanes,
                                      eager):
                    if not torch.equal(a, b):
                        problems.append(f"{m} group of trials {t_ids[:3]}...: the "
                                        f"graph's {name} differ from graph=False's")
                groups_eager += 1
                del eager
                for j, (t, k) in enumerate(blk):
                    if k:
                        continue
                    p = params[t]
                    rf = bool(p.get("rf", False))
                    one = tr.fit_forest(
                        prep["xb"], prep["edge_vals"], prep["y"],
                        lr=p.get("learning_rate", 0.1), lam=p.get("reg_lambda", 1.0),
                        min_child=1.0, subsample=p.get("subsample", 1.0),
                        colsample=p.get("colsample", 1.0),
                        base_score=0.0 if rf else base, seed=t * 131, task="cls",
                        n_trees=int(p.get("n_estimators", 300)),
                        depth=int(p.get("max_depth", 6)),
                        oblivious=bool(p.get("oblivious", False)), rf=rf,
                        row_w=prep["w_kn"][0], n_bins=prep["n_bins"])
                    for name, a, b in zip(("margins", "feats", "thrs", "leaves"),
                                          lanes, one):
                        if not torch.equal(a[j], b):
                            problems.append(f"{m} trial {t} fold 0: the lane's "
                                            f"{name} differ from fit_forest's")
                    checked += 1
            del lanes
        stage_s["search and fold-0 fits"] = time.time() - t_stage
        t_stage = time.time()
        print(f"[14 lane search] tune_zoo with BBBP_FOREST_VMAP on, "
              f"{bs.FOREST_FAMILIES} at phase 10's trials x {n_folds} folds over "
              f"{len(fy)} rows: {search_s:.3f} s | s a family "
              f"{ {m: s['lane_s'] for m, s in scores.items()} } | against phase 10's "
              f"sequential search: {scores} (limit {LANES_SCORE_TOL}) | launches "
              f"{ {k: v for k, v in launches.items() if v or k in single_names} }, "
              f"the fused search, its oblivious form and K3 / K4 with lanes "
              f"{ {m: [f[k] for k in lane_names[:2] + two_kernels] for m, f in family_launches.items()} } "
              f"a family (cat's {cat_lanes} lanes: the fused oblivious search at "
              f"{cat_fused} of {cat_depth} levels) | "
              f"fold 0 of {checked} trials: margins, trees, thresholds and leaves "
              f"bit-equal to fit_forest with the trial's seed; {groups_eager} lane groups "
              f"(every lane) bit-equal to the eager loop (graph=False)", flush=True)

        # -- the lane kernels at L = 15 against their plain versions ----------
        xb, y, n_bins = prep["xb"], prep["y"], prep["n_bins"]
        n, n_feat = xb.shape
        L = LANES_L
        gen = torch.Generator(device=cuda)
        gen.manual_seed(14)
        w = prep["w_kn"][[k % n_folds for k in range(L)]]        # 3 trials x 5 folds
        margins = torch.randn(L, n, generator=gen, device=cuda)
        p = torch.sigmoid(margins)
        g = (p - y) * w
        h = torch.clamp(p * (1 - p), min=1e-6) * w
        g[1] *= 40.0                                # a lane of other bounds
        bounds = tr.gradient_bounds(g, h)
        lam = torch.logspace(-1, 1, L, device=cuda)
        lam_host = lam.tolist()
        held = {"k3_err": 0.0, "k4_near": 0, "k4_err": 0.0, "k4_calls": 0,
                "fused_near": 0, "fused_err": 0.0, "fused_calls": 0, "routed_sorts": 0,
                "oblivious_calls": 0, "oblivious_near": 0, "oblivious_err": 0.0}
        timed = {}
        every = torch.ones(L, n_feat, dtype=torch.bool, device=cuda)
        for level in LANES_LEVELS:
            nodes = 1 << level
            pos = torch.randint(0, nodes, (L, n), generator=gen, dtype=torch.int32,
                                device=cuda)
            hist = tr.level_histogram_lanes(xb, pos, g, h, nodes, bounds, n_bins,
                                            bins_checked=True)
            fixed = tr.level_histogram_lanes_fixed_reference(xb, pos, g, h, nodes,
                                                            bounds)
            single = torch.stack([tr.level_histogram(xb, pos[i], g[i], h[i], nodes,
                                                     bounds[i], n_bins,
                                                     bins_checked=True)
                                  for i in range(L)])
            torch.cuda.synchronize()
            if not (torch.equal(hist, fixed) and torch.equal(hist, single)):
                problems.append(f"level_histogram_lanes level {level}: "
                                f"{int((hist != fixed).sum())} bins off the fixed-point "
                                f"plain version, {int((hist != single).sum())} off "
                                f"the single-fit kernel")
            del fixed, single
            exact = tr.level_histogram_lanes_reference(xb, pos, g.double(), h.double(),
                                                       nodes)
            err = (hist.double() - exact).abs()
            vmax = float(torch.maximum(g.abs().max(), h.abs().max()))
            if bool((err > 2.4e-7 * exact.abs() + 1e-9 * n * vmax).any()):
                problems.append(f"level_histogram_lanes level {level}: max |err| "
                                f"{float(err.max()):.3g} against the float64 sums")
            held["k3_err"] = max(held["k3_err"], float(err.max()))
            del exact, err
            mask = torch.rand(L, n_feat, generator=gen, device=cuda) < 0.7
            mask[:, -1] = True
            for obl, col in ((False, mask), (True, mask), (False, every)):
                got = tr.best_splits_lanes(hist, col, lam, 1.0, obl)
                want = tr.best_splits_lanes_reference(hist, col, lam_host, 1.0, obl)
                for i in range(L):
                    one = tr.best_splits(hist[i], col[i], lam_host[i], 1.0, obl)
                    if not all(torch.equal(a[i], b) for a, b in zip(got, one)):
                        problems.append(f"best_splits_lanes level {level} lane {i} "
                                        f"oblivious={obl}: not the single-fit kernel's")
                    near, worst = split_mismatches(
                        tr, hist[i], col[i], 1.0, obl, [a[i] for a in got],
                        [b[i] for b in want], lam=lam_host[i])
                    held["k4_near"] += near
                    held["k4_err"] = max(held["k4_err"], worst)
                held["k4_calls"] += 1
            f_l, b_l = got[0], got[1]
            hold_fused(tr, xb, pos, g, h, nodes, bounds, n_bins, hist, (mask, every),
                       lam, problems, held)
            routing = hold_lane_routing(tr, xb, pos, g, h, bounds, n_bins, f_l, b_l,
                                        level, every, lam, problems, held)
            # times (CUDA graphs)
            keys = (torch.arange(L, device=cuda)[:, None, None] * (nodes * n_feat * 64)
                    + pos.long()[:, :, None] * (n_feat * 64)
                    + torch.arange(n_feat, device=cuda)[None, None, :] * 64
                    + xb.long()[None]).reshape(-1)
            vals = torch.stack([g, h], dim=-1)[:, :, None, :].expand(
                L, n, n_feat, 2).reshape(-1, 2)
            slow = dict(calls=2, replays=3)         # the plain versions loop over lanes
            timed[level] = {
                "k3": device_ms(lambda: tr.level_histogram_lanes(
                    xb, pos, g, h, nodes, bounds, n_bins, bins_checked=True)),
                "k3_plain": device_ms(lambda: tr.level_histogram_lanes_reference(
                    xb, pos, g, h, nodes), **slow),
                "k3_library": device_ms(lambda: torch.zeros(
                    (L * nodes * n_feat * 64, 2), device=cuda).index_add_(0, keys, vals)),
                "k3_bound": level_histogram_bound(n, n_feat, nodes, L),
                "k4": device_ms(lambda: tr.best_splits_lanes(hist, every, lam, 1.0, False)),
                "k4_plain": device_ms(lambda: tr.best_splits_lanes_reference(
                    hist, every, lam_host, 1.0, False), **slow),
                "k4_oblivious": device_ms(lambda: tr.best_splits_lanes(
                    hist, every, lam, 1.0, True)),
                "k4_oblivious_plain": device_ms(lambda: tr.best_splits_lanes_reference(
                    hist, every, lam_host, 1.0, True), **slow),
                "k4_bound": best_splits_bound(nodes, n_feat, L),
                "fused": device_ms(lambda: tr.level_splits_lanes(
                    xb, pos, g, h, nodes, bounds, every, lam, 1.0, n_bins,
                    bins_checked=True)),
                "fused_one_unit": one_unit_ms(tr, device_ms, lambda: tr.level_splits_lanes(
                    xb, pos, g, h, nodes, bounds, every, lam, 1.0, n_bins,
                    bins_checked=True)),
                "fused_plain": device_ms(lambda: tr.level_splits_lanes_reference(
                    xb, pos, g, h, nodes, every, lam_host, 1.0), **slow),
                "fused_bound": level_splits_bound(n, n_feat, nodes, L,
                                                  occupied_cells(xb, pos, g, h, nodes)),
                **time_lane_routing(tr, device_ms, xb, pos, g, h, bounds, n_bins, every,
                                    lam, routing),
            }
            t = timed[level]
            t["two"] = t["k3"] + t["k4"]
            del hist, keys, vals

        obl = oblivious_levels(tr, device_ms, xb, y, w, n_bins, L, gen, problems, held,
                               plain=True)
        # K5 over lanes with the next tree, 64 and 1,024 leaves, routing the
        # last level's split as a fit calls it, in both launch shapes
        scale = torch.linspace(0.02, 0.3, L, device=cuda)
        sub = torch.linspace(0.6, 1.0, L, device=cuda)
        k5_err, k5 = 0.0, {}
        scale_host, sub_host = scale.tolist(), sub.tolist()
        for n_leaves in (64, 1024):
            case = lane_leaf_case(tr, xb, g, h, bounds, n_leaves, lam, scale, sub, w, y,
                                  margins, gen)
            got = hold_lane_leaves(tr, case, problems, "L=15")
            for i in range(L):
                p_one = margins[i].clone()
                parent = case["parent"]
                one = tr.leaf_values(
                    case["pos"][i].clone(), g[i], h[i], n_leaves, lam_host[i],
                    scale_host[i], p_one, bounds[i],
                    tr.NextTree(y, case["u"][i], sub_host[i], w[i], "cls"),
                    parent=tr.ParentSplit(parent.f_l[i].contiguous(),
                                          parent.b_l[i].contiguous(),
                                          parent.feats[i].clone(), parent.bins[i].clone(),
                                          0, parent.level), xb=xb)
                if not (torch.equal(p_one, got["margins"][i])
                        and all(torch.equal(a[i], b) for a, b in zip(got["out"], one))):
                    problems.append(f"leaf_values_lanes {n_leaves} leaves lane {i}: "
                                    f"not the single-fit kernel's")
            leaf_64 = tr.leaf_values_lanes_reference(
                case["routed"], g.double(), h.double(), n_leaves, lam_host,
                scale.tolist(), margins.double())
            k5_err = max(k5_err, float((got["out"][0].double() - leaf_64).abs().max()))
            k5[n_leaves] = time_lane_leaves(tr, device_ms, leaf_values_bound, case, xb, g,
                                            h, bounds, lam, scale, margins, n_feat,
                                            slow=slow)

        # -- the fused search against K3 then K4 with lanes at L = 250 --------
        WL = LANES_WIDE_L
        w_wide = prep["w_kn"][[k % n_folds for k in range(WL)]]   # 50 trials x 5 folds
        p_wide = torch.sigmoid(torch.randn(WL, n, generator=gen, device=cuda))
        g_wide = (p_wide - y) * w_wide
        h_wide = torch.clamp(p_wide * (1 - p_wide), min=1e-6) * w_wide
        g_wide[1] *= 40.0
        bounds_wide = tr.gradient_bounds(g_wide, h_wide)
        lam_wide = torch.logspace(-1, 1, WL, device=cuda)
        mask_wide = torch.rand(WL, n_feat, generator=gen, device=cuda) < 0.7
        mask_wide[:, -1] = True
        every_wide = torch.ones(WL, n_feat, dtype=torch.bool, device=cuda)
        wide = {}
        for level in LANES_LEVELS:
            nodes = 1 << level
            pos_w = torch.randint(0, nodes, (WL, n), generator=gen, dtype=torch.int32,
                                  device=cuda)
            hist_w = tr.level_histogram_lanes(xb, pos_w, g_wide, h_wide, nodes,
                                              bounds_wide, n_bins, bins_checked=True)
            hold_fused(tr, xb, pos_w, g_wide, h_wide, nodes, bounds_wide, n_bins, hist_w,
                       (mask_wide, every_wide), lam_wide, problems, held,
                       plain_lanes=range(0, WL, 10))
            f_w, b_w, _ = tr.level_splits_lanes(xb, pos_w, g_wide, h_wide, nodes,
                                                bounds_wide, every_wide, lam_wide, 1.0,
                                                n_bins, bins_checked=True)
            routing_w = hold_lane_routing(tr, xb, pos_w, g_wide, h_wide, bounds_wide,
                                          n_bins, f_w, b_w, level, every_wide, lam_wide,
                                          problems, held, sort_lanes=range(0, WL, 10),
                                          with_k3=False)
            # the histogram is 7.9 GB at level 11: two calls a graph there
            few = dict(calls=2, replays=5) if level >= 9 else {}
            wide[level] = {
                "fused": device_ms(lambda: tr.level_splits_lanes(
                    xb, pos_w, g_wide, h_wide, nodes, bounds_wide, every_wide, lam_wide,
                    1.0, n_bins, bins_checked=True)),
                "fused_one_unit": one_unit_ms(tr, device_ms, lambda: tr.level_splits_lanes(
                    xb, pos_w, g_wide, h_wide, nodes, bounds_wide, every_wide, lam_wide,
                    1.0, n_bins, bins_checked=True)),
                "k3": device_ms(lambda: tr.level_histogram_lanes(
                    xb, pos_w, g_wide, h_wide, nodes, bounds_wide, n_bins,
                    bins_checked=True), **few),
                "k4": device_ms(lambda: tr.best_splits_lanes(
                    hist_w, every_wide, lam_wide, 1.0, False), **few),
                "k4_oblivious": device_ms(lambda: tr.best_splits_lanes(
                    hist_w, every_wide, lam_wide, 1.0, True), **few),
                "fused_bound": level_splits_bound(
                    n, n_feat, nodes, WL,
                    occupied_cells(xb, pos_w, g_wide, h_wide, nodes)),
                "k3_bound": level_histogram_bound(n, n_feat, nodes, WL),
                "k4_bound": best_splits_bound(nodes, n_feat, WL),
                **time_lane_routing(tr, device_ms, xb, pos_w, g_wide, h_wide, bounds_wide,
                                    n_bins, every_wide, lam_wide, routing_w)}
            wide[level]["two"] = wide[level]["k3"] + wide[level]["k4"]
            del hist_w, routing_w
            torch.cuda.empty_cache()
        obl_wide = oblivious_levels(tr, device_ms, xb, y, w_wide, n_bins, WL, gen,
                                    problems, held, plain_lanes=range(0, WL, 10))
        # K5 with lanes at L = 250 in both launch shapes, routing as in a fit
        k5_wide = {}
        margins_wide = torch.randn(WL, n, generator=gen, device=cuda)
        scale_wide = torch.linspace(0.02, 0.3, WL, device=cuda)
        sub_wide = torch.linspace(0.6, 1.0, WL, device=cuda)
        for n_leaves in (64, 1024):
            case = lane_leaf_case(tr, xb, g_wide, h_wide, bounds_wide, n_leaves, lam_wide,
                                  scale_wide, sub_wide, w_wide, y, margins_wide, gen)
            hold_lane_leaves(tr, case, problems, f"L={WL}", plain_lanes=range(0, WL, 10))
            k5_wide[n_leaves] = time_lane_leaves(tr, device_ms, leaf_values_bound, case, xb,
                                                 g_wide, h_wide, bounds_wide, lam_wide,
                                                 scale_wide, margins_wide, n_feat)
            del case
        del g_wide, h_wide, p_wide, w_wide, margins_wide

        stage_s["kernels held and timed"] = time.time() - t_stage
        t_stage = time.time()
        # -- xgb's, rf's and cat's tuned groups: 50 + 1 trials x 5 folds ------
        groups = {}
        for m in ("xgb", "rf", "cat"):
            groups[m] = searched_group(m)
            stage_s[f"{m} group"] = time.time() - t_stage
            t_stage = time.time()
    finally:
        bs.FOREST_VMAP = vmap_before
    for m, (trees, depth) in (("xgb", (300, 6)), ("rf", (300, 10)), ("cat", (300, 6))):
        info = groups[m]
        group = info["group"]
        print(f"[14 {m} group] batched_random_search({m!r}) with the lanes, "
              f"{len(group.trials)} trials x {tcfg.search_folds} folds over {len(fy)} rows "
              f"({trees} trees x depth {depth}; lanes and blocks by shape "
              f"{info['lane_blocks']}): {info['wall_s']:.3f} s wall, peak allocated "
              f"{info['peak_gib_above_live']:.3f} GiB above the {info['live_gib']:.3f} GiB "
              f"live before it, launches {info['launches']} | the whole search again "
              f"under torch.profiler ({info['tree_steps']} tree steps, the trees after "
              f"each group's first a replayed CUDA graph): "
              f"{info['profiled_s']:.3f} s, device busy {info['busy_ms']:.1f} ms "
              f"({info['busy_ms'] / 1e3 / info['profiled_s']:.1%}), "
              f"{info['host_launch_calls']} host launch calls "
              f"({info['host_launch_calls'] / info['tree_steps']:.2f} a tree step), "
              f"{info['generator_draws']} "
              f"torch.Generator draws (aten::rand, aten::poisson), profiler "
              f"post-processing {info['profiler_post_s']:.1f} s | best CV accuracy "
              f"{group.best_score:.4f} {group.best_params}", flush=True)
    print(f"[14 stages] phase 14 stage s "
          f"{ {k: round(v, 1) for k, v in stage_s.items()} }", flush=True)

    def lv(key, field=None, at=None):
        at = timed if at is None else at
        return [at[lv_][key][field] if field else at[lv_][key] for lv_ in LANES_LEVELS]

    def wv(key, field=None):                # at L = 250
        return lv(key, field, wide)

    def ov(key, at, field=None):            # the oblivious search's levels
        return [at[lv_][key][field] if field else at[lv_][key] for lv_ in OBLIVIOUS_LEVELS]

    print(f"[14 lane kernels] L={L} lanes (3 trials x 5 folds' row weights), "
          f"n={n}, F={n_feat}, levels {list(LANES_LEVELS)} (ms): "
          f"level_histogram_lanes {fmt(lv('k3'))}, plain {fmt(lv('k3_plain'))}, "
          f"index_add_ over the lanes' keys {fmt(lv('k3_library'))}, bound "
          f"{fmt(lv('k3_bound', 'bound_ms'))}; best_splits_lanes {fmt(lv('k4'))}, "
          f"plain {fmt(lv('k4_plain'))}, oblivious {fmt(lv('k4_oblivious'))}, plain "
          f"{fmt(lv('k4_oblivious_plain'))}, bound {fmt(lv('k4_bound', 'bound_ms'))}; "
          f"leaf_values_lanes with the next tree and routing, 64 / 1,024 leaves "
          f"{k5_line(k5)} | K3 bit-equal to its fixed-point "
          f"plain version and to the single-fit kernel lane by lane, max |err| "
          f"{held['k3_err']:.3g} against the float64 sums; K4 ({held['k4_calls']} "
          f"calls, per node and oblivious, lambda 0.1-10 a lane, column masks) equal "
          f"to the single-fit kernel lane by lane and to the plain version but "
          f"{held['k4_near']} counted near ties (max |dscore| {held['k4_err']:.3g}); "
          f"K5 with the next tree and routing, in both launch shapes, bit-equal to "
          f"route_rows_reference then its fixed-point plain version and to the "
          f"single-fit kernel, max |dleaf| {k5_err:.3g} against the float64 sums | "
          f"phase 14 {time.time() - t14:.1f} s on {card}", flush=True)
    print(f"[14 K5 with lanes] leaf_values_lanes with the next tree and routing, "
          f"n={n}, 64 / 1,024 leaves (ms): L={LANES_WIDE_L} {k5_line(k5_wide)} | the "
          f"shapes' bits equal, every 10th lane bit-equal to route_rows_reference then "
          f"the fixed-point plain version", flush=True)
    print(f"[14 routing] the split of levels {list(LANES_LEVELS)} routed in the "
          f"next level's fused search, n={n}, F={n_feat} (ms): L={L} with routing "
          f"{fmt(lv('route_fused'))} against the search alone on the routed rows "
          f"{fmt(lv('route_alone'))}: added {fmt(lv('route'))}, bound "
          f"{fmt(lv('route_bound', 'bound_ms'))}, route_rows_reference "
          f"{fmt(lv('route_plain'))} (each with pos restored, the copy "
          f"{fmt(lv('route_copy'))} taken off); L={LANES_WIDE_L} with routing "
          f"{fmt(wv('route_fused'))} against {fmt(wv('route_alone'))}: added "
          f"{fmt(wv('route'))}, bound {fmt(wv('route_bound', 'bound_ms'))}, "
          f"route_rows_reference {fmt(wv('route_plain'))} | {held['routed_sorts']} sorts "
          f"with routing (the fused search's and K3 with lanes', lane 0's single fit): "
          f"positions and the trees' pairs equal to route_rows_reference, each node's "
          f"rows as a set, results bit-equal to the calls on the routed positions",
          flush=True)
    print(f"[14 fused split search] level_splits_lanes, n={n}, F={n_feat}, levels "
          f"{list(LANES_LEVELS)} (ms): L={L} {fmt(lv('fused'))} (a unit a warp "
          f"{fmt(lv('fused_one_unit'))}) against K3 + K4 with "
          f"lanes {fmt(lv('two'))}, plain {fmt(lv('fused_plain'))}, bound "
          f"{fmt(lv('fused_bound', 'bound_ms'))}; L={LANES_WIDE_L} {fmt(wv('fused'))} "
          f"(a unit a warp {fmt(wv('fused_one_unit'))}) "
          f"against K3 + K4 with lanes {fmt(wv('two'))} (K3 {fmt(wv('k3'))}, K4 "
          f"{fmt(wv('k4'))}, oblivious {fmt(wv('k4_oblivious'))}), bound "
          f"{fmt(wv('fused_bound', 'bound_ms'))} (K3 {fmt(wv('k3_bound', 'bound_ms'))}, "
          f"K4 {fmt(wv('k4_bound', 'bound_ms'))}) | {held['fused_calls']} calls "
          f"(min_child 0 and 1, column masks and none, lambda 0.1-10 a lane, a lane "
          f"of 40x gradients, zero-weight rows) bit-equal to K3 then K4 with lanes, "
          f"and to the fixed-point plain version (all lanes at L={L}, every 10th at "
          f"L={LANES_WIDE_L}) but {held['fused_near']} counted near ties (max "
          f"|dscore| {held['fused_err']:.3g}) | oblivious "
          f"(level_splits_oblivious_lanes), levels {list(OBLIVIOUS_LEVELS)}: "
          + " ; ".join(
              f"L={lanes_} {fmt(ov('fused', at))} against K3 + K4 with lanes "
              f"{fmt(ov('two', at))} (K3 {fmt(ov('k3', at))}, K4 {fmt(ov('k4', at))}), "
              f"bound {fmt(ov('bound', at, 'bound_ms'))}"
              + f"; at levels {list(OBLIVIOUS_LIBRARY_LEVELS)} "
              + (f"plain {fmt([at[lv_]['plain'] for lv_ in OBLIVIOUS_LIBRARY_LEVELS])}, "
                 if "plain" in at[0] else "")
              + f"K3 with lanes' index_add_ "
              f"{fmt([at[lv_]['k3_library'] for lv_ in OBLIVIOUS_LIBRARY_LEVELS])}"
              for lanes_, at in ((L, obl), (LANES_WIDE_L, obl_wide)))
          + f" | {held['oblivious_calls']} calls (the level before routed in place, half "
          f"its nodes sending every row left, min_child 0 and 1, column masks and none, "
          f"lambda 0.1-10 a lane, a lane of 40x gradients) bit-equal to K3 then K4 with "
          f"lanes (oblivious), and to the fixed-point plain version (all lanes at L={L}, "
          f"every 10th at L={LANES_WIDE_L}) but {held['oblivious_near']} counted near-tie "
          f"lane levels (max |dscore| {held['oblivious_err']:.3g})", flush=True)
    # a lane kernel's launches on the path: the five searches' and the groups'
    path_launches = {name: launches[name] + sum(g_["launches"].get(name, 0)
                                                for g_ in groups.values())
                     for name in lane_names + two_kernels}
    for name in lane_names:
        if not path_launches[name]:
            problems.append(f"phase 14 launched no {name}")
    if problems:
        raise AssertionError("phase 14: " + " | ".join(problems))
    main = LANES_LEVELS.index(5)
    replaces = {"forest_level_splits_lanes": "bbbp_tpu/ops/forest_tpu.py:154",
                "forest_level_splits_oblivious_lanes": "bbbp_tpu/ops/forest_tpu.py:135",
                "forest_leaf_values_lanes": "bbbp_tpu/ops/forest_tpu.py:340",
                "forest_level_histogram_lanes": "bbbp_tpu/ops/forest_tpu.py:188",
                "forest_best_splits_lanes": "bbbp_tpu/ops/forest_tpu.py:125"}
    entries = []
    # K3 and K4 with lanes are on the path where cat's searches gave them levels
    on_path = lane_names + tuple(k for k in two_kernels if path_launches[k])
    for name in on_path:
        entry = {"name": name, "route": "cuda",
                 "source": "bbbp_tpu_torch/csrc/forest_train.cu",
                 "replaces": replaces[name], "launches": path_launches[name],
                 "launches_searches": launches[name],
                 "launches_by_family": {m: f[name] for m, f in family_launches.items()},
                 **{f"launches_{m}_group": groups[m]["launches"].get(name, 0)
                    for m in groups}}
        if name == "forest_level_splits_oblivious_lanes":
            t = obl[5]
            entry.update(
                max_abs_err=held["oblivious_err"], ms=t["fused"], plain_ms=t["plain"],
                bound_ms=t["bound"]["bound_ms"], bound_by=t["bound"]["bound_by"],
                library_ms=None,
                shape=f"L={L}, n={n}, F={n_feat}, level 5",
                levels=list(OBLIVIOUS_LEVELS), bit_equal_to_two_kernels_calls=
                held["oblivious_calls"], near_tie_lane_levels=held["oblivious_near"])
            for at, suffix in ((obl, ""), (obl_wide, f"_L{LANES_WIDE_L}")):
                entry["ms_levels" + suffix] = ov("fused", at)
                entry["bound_ms_levels" + suffix] = ov("bound", at, "bound_ms")
                entry["two_kernel_ms_levels" + suffix] = ov("two", at)
                entry["k3_lanes_ms_levels" + suffix] = ov("k3", at)
                entry["k4_lanes_oblivious_ms_levels" + suffix] = ov("k4", at)
                entry["k3_lanes_library_ms" + suffix] = {
                    f"level {lv_}": at[lv_]["k3_library"] for lv_ in OBLIVIOUS_LIBRARY_LEVELS}
            entry["plain_ms_levels"] = {f"level {lv_}": obl[lv_]["plain"]
                                        for lv_ in OBLIVIOUS_LIBRARY_LEVELS}
            entry["library_call_of_k3_lanes"] = (
                "torch.zeros(...).index_add_(0, keys, (g, h) values) over the lanes' keys, "
                "made beforehand: K3 with lanes' function, not the search's")
        elif name in two_kernels:
            t = timed[LANES_LEVELS[main]]
            k3 = name == "forest_level_histogram_lanes"
            key = "k3" if k3 else "k4_oblivious"    # cat's search runs K4's oblivious mode
            entry.update(
                max_abs_err=held["k3_err"] if k3 else held["k4_err"], ms=t[key],
                plain_ms=t[key + "_plain"], bound_ms=t["k3_bound" if k3 else "k4_bound"]
                ["bound_ms"], bound_by=t["k3_bound" if k3 else "k4_bound"]["bound_by"],
                library_ms=t["k3_library"] if k3 else None,
                shape=f"L={L}, n={n}, F={n_feat}, level {LANES_LEVELS[main]}"
                      + ("" if k3 else ", oblivious"),
                levels=list(LANES_LEVELS), ms_levels=lv(key), plain_ms_levels=lv(key + "_plain"),
                bound_ms_levels=lv("k3_bound" if k3 else "k4_bound", "bound_ms"),
                **{f"ms_levels_L{LANES_WIDE_L}": wv(key)})
            if k3:
                entry["library_call"] = ("torch.zeros(...).index_add_(0, keys, (g, h) "
                                         "values) over the lanes' keys, made beforehand")
                entry["library_ms_levels"] = lv("k3_library")
            else:
                entry["near_tie_nodes"] = held["k4_near"]
        elif name == "forest_leaf_values_lanes":
            t = k5[64]
            entry.update(max_abs_err=k5_err, ms=t["ms"], plain_ms=t["plain_ms"],
                         bound_ms=t["bound"]["bound_ms"],
                         bound_by=t["bound"]["bound_by"], library_ms=None,
                         shape=f"L={L}, n={n}, 64 leaves, with the next tree and "
                               f"routing")
            for at, suffix in ((k5, ""), (k5_wide, f"_L{LANES_WIDE_L}")):
                for leaves in (64, 1024):
                    tail = suffix + ("_1024_leaves" if leaves == 1024 else "")
                    t_ = at[leaves]
                    entry["ms_cluster" + tail] = t_["ms_cluster"]
                    entry["ms_block" + tail] = t_["ms_block"]
                    if tail:
                        entry["ms" + tail] = t_["ms"]
                        entry["bound_ms" + tail] = t_["bound"]["bound_ms"]
                        if "plain_ms" in t_:
                            entry["plain_ms" + tail] = t_["plain_ms"]
        else:
            t = timed[LANES_LEVELS[main]]
            entry.update(
                max_abs_err=held["fused_err"], ms=t["fused"], plain_ms=t["fused_plain"],
                bound_ms=t["fused_bound"]["bound_ms"],
                bound_by=t["fused_bound"]["bound_by"], library_ms=None,
                shape=f"L={L}, n={n}, F={n_feat}, level {LANES_LEVELS[main]}",
                levels=list(LANES_LEVELS), ms_levels=lv("fused"),
                plain_ms_levels=lv("fused_plain"),
                bound_ms_levels=lv("fused_bound", "bound_ms"))
            entry[f"ms_levels_L{LANES_WIDE_L}"] = wv("fused")
            entry[f"bound_ms_levels_L{LANES_WIDE_L}"] = wv("fused_bound", "bound_ms")
            # K3 and K4 with lanes, its yardstick, at the same shapes
            entry["yardstick"] = {
                "k3_lanes_ms_levels": lv("k3"), "k3_lanes_plain_ms_levels": lv("k3_plain"),
                "k3_lanes_bound_ms_levels": lv("k3_bound", "bound_ms"),
                "k3_lanes_library_ms_levels": lv("k3_library"),
                "k4_lanes_ms_levels": lv("k4"), "k4_lanes_plain_ms_levels": lv("k4_plain"),
                "k4_lanes_oblivious_ms_levels": lv("k4_oblivious"),
                "k4_lanes_oblivious_plain_ms_levels": lv("k4_oblivious_plain"),
                "k4_lanes_bound_ms_levels": lv("k4_bound", "bound_ms"),
                "k3_lanes_max_abs_err": held["k3_err"], "k4_lanes_near_tie_nodes":
                held["k4_near"],
                f"k3_lanes_ms_levels_L{LANES_WIDE_L}": wv("k3"),
                f"k4_lanes_ms_levels_L{LANES_WIDE_L}": wv("k4"),
                f"k4_lanes_oblivious_ms_levels_L{LANES_WIDE_L}": wv("k4_oblivious")}
            entry["routed_levels"] = [f"{lv_} -> {lv_ + 1}" for lv_ in LANES_LEVELS]
            for at, suffix in ((lv, ""), (wv, f"_L{LANES_WIDE_L}")):
                entry["ms_with_routing_levels" + suffix] = at("route_fused")
                entry["ms_alone_levels" + suffix] = at("route_alone")
                entry["routing_added_ms_levels" + suffix] = at("route")
                entry["routing_bound_ms_levels" + suffix] = at("route_bound", "bound_ms")
                entry["routing_plain_ms_levels" + suffix] = at("route_plain")
            entry["two_kernel_ms_levels"] = lv("two")
            entry["one_unit_a_warp_ms_levels"] = lv("fused_one_unit")
            entry[f"one_unit_a_warp_ms_levels_L{LANES_WIDE_L}"] = wv("fused_one_unit")
            entry[f"two_kernel_ms_levels_L{LANES_WIDE_L}"] = wv("two")
            entry["near_tie_nodes"] = held["fused_near"]
            entry["bit_equal_to_two_kernels_calls"] = held["fused_calls"]
        entries.append(entry)
    for m, info in groups.items():
        group_info = {k: v for k, v in info.items() if k != "group"}
        group_info.update(trials=len(info["group"].trials))
        for entry in entries:
            entry[f"{m}_group"] = group_info
    return {"kernels": entries}


def draw_seeds(lanes: int) -> list:
    """A lane group's seeds, as ``_forest_cv_vmapped`` gives them: t * 131 + k
    for trial t and fold k of 5; one lane takes the estimators' seed 42."""
    return [42] if lanes == 1 else [t * 131 + k for t in range(-(-lanes // 5))
                                    for k in range(5)][:lanes]


def draws_holds(tr, problems) -> dict:
    """K9 against its plain version on the CPU, bit for bit, for one fit
    (n = 7,809) and L = 15 and 255 lanes (n = 8,162, phase 14's search rows),
    every stream, a tree index read from the device with and without the
    next tree's offset; each timed beside its plain version (on the card)
    and its bound."""
    import torch

    from bbbp_tpu_torch.timing import device_ms, event_ms, forest_draws_bound

    cuda = torch.device("cuda")
    out = {}
    for lanes, n in ((1, TRAIN_ROWS[0]), (LANES_L, 8162), (DRAW_WIDE_L, 8162)):
        seeds = torch.tensor(draw_seeds(lanes))
        seeds_d = seeds.to(cuda)
        for stream, size in (("subsample", n), ("columns", TRAIN_F), ("poisson", n)):
            err = 0.0
            for tree, offset in ((0, 0), (298, 1)):
                got = tr.forest_draws(seeds_d, torch.tensor([tree], device=cuda), stream,
                                      size, tree_offset=offset).cpu()
                want = tr.forest_draws_reference(seeds, tree + offset, stream, size)
                err = max(err, float((got.double() - want.double()).abs().max()))
                if not torch.equal(got, want):
                    problems.append(f"forest_draws L={lanes} {stream} tree {tree}+{offset}: "
                                    f"not its plain version's bits")
            tree_d = torch.tensor([7], device=cuda)
            out[lanes, stream] = {
                "size": size, "max_abs_err": err,
                "ms": device_ms(lambda: tr.forest_draws(seeds_d, tree_d, stream, size)),
                "plain_ms": event_ms(lambda: tr.forest_draws_reference(
                    seeds_d, 7, stream, size), calls=10),
                "bound": forest_draws_bound(lanes, size, stream == "poisson")}
    return out


def graph_holds(tr, z_np, labels, problems) -> dict:
    """Every fit form bit-equal to the eager loop (``graph=False``) on the
    card, one fit and three lanes (their seeds as a search's), with each
    kernel's launches the same: boosting at subsample 0.8 and colsample 0.6,
    oblivious, and a random forest of depth 10, over the default model's
    binned z."""
    import torch

    cuda = torch.device("cuda")
    mapper = tr.BinMapper().fit(z_np)
    xb = torch.from_numpy(mapper.transform(z_np)).to(cuda)
    edges = torch.from_numpy(mapper.edge_values()).to(cuda)
    n_bins = torch.from_numpy(mapper.bin_counts()).to(cuda)
    y = torch.from_numpy(labels.astype(np.float32)).to(cuda)
    base = float(y.mean())
    kinds = {"gbdt": dict(task="cls", rf=False, oblivious=False, depth=TRAIN_DEPTH,
                          base_score=base),
             "oblivious": dict(task="cls", rf=False, oblivious=True, depth=TRAIN_DEPTH,
                               base_score=base),
             "rf": dict(task="reg", rf=True, oblivious=False, depth=10, base_score=0.0)}
    held = {}
    for name, kw in kinds.items():
        lam = 1e-6 if kw["rf"] else 1.0
        one = dict(lr=0.1, lam=lam, min_child=1.0, subsample=0.8, colsample=0.6,
                   seed=42, n_trees=GRAPH_TREES, n_bins=n_bins, **kw)
        lanes = dict(lr=0.1, lam=lam, subsample=0.8, colsample=0.6, seeds=draw_seeds(3),
                     row_w=torch.ones(3, len(y), device=cuda), n_trees=GRAPH_TREES,
                     n_bins=n_bins, **kw)
        for fit, args in ((tr.fit_forest, one), (tr.fit_forest_lanes, lanes)):
            outs, counts = [], []
            for graph in (False, True):
                for c in tr.TREE_KERNELS:
                    c.launches.reset()
                outs.append(fit(xb, edges, y, graph=graph, **args))
                torch.cuda.synchronize()
                counts.append({c.__name__: c.launches.count for c in tr.TREE_KERNELS})
            same = [torch.equal(a, b) for a, b in zip(*outs)]
            if not all(same) or counts[0] != counts[1]:
                problems.append(f"{name} {fit.__name__}: graph against eager, outputs "
                                f"equal {same}, launches {counts}")
            held[name, fit.__name__] = counts[1]
    return held


def stochastic_holds(z_np, labels, problems) -> dict:
    """Keyed draws are the same on the card and the CPU, so a stochastic
    fit is held card against CPU by phase 6's rule: ``GBDTClassifier
    (subsample=0.8, colsample=0.6)`` at the default model's width and a
    ``RandomForestClassifier`` of ``RF_AUDIT_TREES`` trees of depth 10 (its
    300 cut for the CPU's replay), each against the CPU fit up to equivalent
    splits and its first near tie, and along its own splits against the
    plain best split (near ties at most 1%, leaves within 1e-4)."""
    from bbbp_tpu_torch.ops.forest_train import GBDTClassifier, RandomForestClassifier
    from bbbp_tpu_torch.testing import compare_gbdt_fits

    out = {}
    fits = {
        "gbdt": (lambda dev: GBDTClassifier(
            n_estimators=N_TREES_STOCHASTIC, learning_rate=0.1, max_depth=TRAIN_DEPTH,
            subsample=0.8, colsample=0.6, seed=42, device=dev),
            dict(task="cls", lam=1.0, learning_rate=0.1, subsample=0.8, colsample=0.6)),
        "rf": (lambda dev: RandomForestClassifier(
            n_estimators=RF_AUDIT_TREES, max_depth=10, seed=42, device=dev),
            dict(task="reg", lam=1e-6, learning_rate=1.0, colsample=0.5, rf=True))}
    for name, (make, kw) in fits.items():
        t0 = time.time()
        on_cuda = make("cuda").fit(z_np, labels)
        on_cpu = make("cpu").fit(z_np, labels)
        args = dict(kw, min_child=1.0, seed=42, tol=1e-5,
                    base_score=on_cpu.ensemble_.base_score)
        state = on_cuda.ensemble_.to_state()
        cmp = compare_gbdt_fits(z_np, labels, on_cpu.ensemble_.to_state(), state, **args)
        audit = compare_gbdt_fits(z_np, labels, None, state, **args)
        nodes = audit.trees_compared * ((1 << state["depth"]) - 1)
        if not (cmp.ok and audit.ok) or audit.near_ties > 0.01 * nodes or \
                audit.max_leaf_diff > 1e-4 or audit.trees_compared != len(state["feat"]):
            problems.append(f"{name} cuda vs cpu (keyed draws): {cmp}; along the cuda "
                            f"fit's own splits: {audit}")
        out[name] = {"cmp": cmp, "audit": audit, "s": time.time() - t0}
    return out


def own_children() -> list:
    """PIDs of this process's children, zombies included, from ``/proc``."""
    me, pids = str(os.getpid()), []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # "pid (comm) state ppid ...": comm may hold spaces and parentheses
        if stat[stat.rindex(")") + 2:].split()[1] == me:
            pids.append(int(entry))
    return pids


def command_line(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace").strip()
    except OSError:
        return "?"


def stop_children() -> None:
    """Stop and reap every process this run started that is still alive.

    The featurizer's spawned pool leaves multiprocessing's resource tracker
    running until the interpreter exits, so it is stopped first, the way
    the interpreter would. Any other child is sent SIGTERM, then SIGKILL
    after 5 s. ``main`` makes this process the subreaper of its
    descendants, so a grandchild whose parent has exited is found here
    too. What was stopped goes to stderr."""
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    if tracker._pid is not None:
        print(f"chip_smoke: stopping multiprocessing's resource tracker "
              f"(pid {tracker._pid})", file=sys.stderr, flush=True)
        tracker._stop()
    for sig, grace in ((signal.SIGTERM, 5.0), (signal.SIGKILL, 30.0)):
        pids = own_children()
        if not pids:
            return
        print(f"chip_smoke: sending {sig.name} to "
              f"{[(pid, command_line(pid)) for pid in pids]}",
              file=sys.stderr, flush=True)
        for pid in pids:
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        deadline = time.time() + grace
        while pids and time.time() < deadline:
            for pid in list(pids):
                try:
                    done, _ = os.waitpid(pid, os.WNOHANG)
                except ChildProcessError:
                    done = pid
                if done:
                    pids.remove(pid)
            time.sleep(0.05)


def main() -> int:
    # PR_SET_CHILD_SUBREAPER: orphaned descendants become this process's
    # children, so that stop_children() finds them
    ctypes.CDLL(None).prctl(36, 1, 0, 0, 0)
    try:
        return run()
    finally:
        stop_children()


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    from bbbp_tpu_torch import _build
    from bbbp_tpu_torch.data.zinc import synthetic_smiles
    from bbbp_tpu_torch.native.bindings import fingerprints, fingerprints_packed
    from bbbp_tpu_torch.ops import forest_train as tr
    from bbbp_tpu_torch.ops.bitops import (pack_bits, packed_project,
                                           packed_project_reference,
                                           unpack_bits_reference)
    from bbbp_tpu_torch.ops.forest import (DenseTreeEnsemble,
                                           dense_predict_reference, raw_predict)
    from bbbp_tpu_torch.ops.forest_train import GBDTClassifier
    from bbbp_tpu_torch.pipelines.screen import ScreeningModel, screen
    from bbbp_tpu_torch.testing import (N_TREES, compare_gbdt_fits,
                                        full_width_screening_state,
                                        labelled_training_set, mixed_level_case)
    from bbbp_tpu_torch.timing import (best_splits_bound, device_ms, event_ms,
                                       forest_bound, host_launch_calls,
                                       level_histogram_bound, nvidia_smi,
                                       project_bound)

    cuda = torch.device("cuda")
    card = nvidia_smi()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False      # phase 9's f32 convolutions
    t0 = time.time()
    _build.kernels_lib()
    t_kernels = time.time() - t0
    t0 = time.time()
    _build.chem_lib()
    t_chem = time.time() - t0
    print(f"[1 env] card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | allow_tf32={tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32} | build s: kernels "
          f"{t_kernels:.1f}, chem {t_chem:.1f}", flush=True)
    if tf32:
        raise AssertionError("torch.backends.cuda.matmul.allow_tf32 must be False")

    state = full_width_screening_state(0)
    model = ScreeningModel.from_state(state).to(cuda)
    rng = np.random.default_rng(0)

    # -- phase 2: kernel 1 against its plain version ----------------------
    w, c0 = model.proj_w, model.proj_c0
    k1_err = 0.0
    cases = [(n, 2048, 30) for n in (1, 255, 16384, 16385)]
    cases += [(16385, 2048, 64), (16385, 2048, 50), (16385, 2048, 31),
              (16385, 2048, 200), (255, 2048, 1001), (255, 2000, 30),
              (16385, 2000, 30)]
    for n, d, k in cases:
        if (d, k) == (2048, 30):
            wk, ck = w, c0
        else:
            wk = torch.from_numpy((rng.standard_normal((d, k)) / np.sqrt(d)
                                   ).astype(np.float32)).to(cuda)
            ck = torch.from_numpy(rng.standard_normal(k).astype(np.float32)
                                  ).to(cuda)
        dense = rng.random((n, 2048)) < 0.05
        dense[-1] = True                        # an all-ones row
        if n > 1:
            dense[0] = False                    # an all-zero row
        packed = torch.from_numpy(pack_bits(dense).view(np.int32)).to(cuda)
        got = packed_project(packed, wk, ck)
        want = packed_project_reference(packed, wk, ck)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        k1_err = max(k1_err, err)
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-4):
            raise AssertionError(f"packed_project N={n} d={d} k={k}: "
                                 f"max |err| {err:.3g}")
        if (n, d, k) == (CHUNK + 1, 2048, 30):
            random_words = packed[:CHUNK]       # 5%-random, first row zero
    fp_words, _ = fingerprints_packed(synthetic_smiles(CHUNK, seed=1))
    fp_words = torch.from_numpy(fp_words.view(np.int32)).to(cuda)
    set_bits = {name: int(unpack_bits_reference(words, w.shape[0]).sum().item())
                for name, words in (("random", random_words),
                                    ("fingerprints", fp_words))}
    k1_ms = device_ms(lambda: packed_project(random_words, w, c0))
    k1_plain_ms = device_ms(lambda: packed_project_reference(random_words, w,
                                                             c0))
    random_bits = unpack_bits_reference(random_words, w.shape[0])
    k1_lib_ms = device_ms(lambda: torch.addmm(c0, random_bits, w))
    k1_fp_ms = device_ms(lambda: packed_project(fp_words, w, c0))
    k1_fp_plain_ms = device_ms(lambda: packed_project_reference(fp_words, w,
                                                                c0))
    k1_bound, k1_fp_bound = (
        project_bound(CHUNK, random_words.shape[1], w.shape[0], w.shape[1],
                      set_bits[name]) for name in ("random", "fingerprints"))
    print(f"[2 packed_project] (N, d, k) in {cases}: max |err| {k1_err:.3g} "
          f"(atol 1e-4, rtol 1e-5) | N=16384, W=64, k=30: 5%-random words "
          f"({set_bits['random'] / CHUNK:.2f} set bits a row) kernel "
          f"{k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms, addmm on unpacked "
          f"bits {k1_lib_ms:.4f} ms, bound {k1_bound['bound_ms']:.5f} ms "
          f"({k1_bound['bound_by']}); fingerprints "
          f"({set_bits['fingerprints'] / CHUNK:.2f} set bits a row) kernel "
          f"{k1_fp_ms:.4f} ms, plain {k1_fp_plain_ms:.4f} ms, bound "
          f"{k1_fp_bound['bound_ms']:.5f} ms ({k1_fp_bound['bound_by']})",
          flush=True)

    # -- phase 3: kernel 2 against its plain version -----------------------
    k2_err = 0.0
    n = 16384
    cases = [(depth, n_feat, 300) for depth in (0, 1, 6, 8, 12)
             for n_feat in (30, 2048)] + [(6, 30, 301)]
    cases += [(depth, WIDE_F, n_trees) for depth, n_trees in WIDE_FORESTS]
    wide = {}
    for depth, n_feat, n_trees in cases:
        x = torch.from_numpy(
            rng.standard_normal((n, n_feat)).astype(np.float32)).to(cuda)
        n_int = (1 << depth) - 1
        thr = rng.standard_normal((n_trees, n_int)).astype(np.float32)
        thr[rng.random(thr.shape) < 0.05] = np.inf
        ens = DenseTreeEnsemble.from_state({
            "feat": rng.integers(0, n_feat, (n_trees, n_int)), "thr": thr,
            "leaf": rng.normal(0, 0.1, (n_trees, n_int + 1)),
            "depth": depth, "base_score": 0.3, "tree_scale": 0.1}).to(cuda)
        want = dense_predict_reference(ens.feat, ens.thr, ens.leaf, x, depth,
                                       ens.base_score, ens.tree_scale)
        got = raw_predict(ens, x)
        got_p = raw_predict(ens, x, apply_sigmoid=True)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        err_p = (got_p - torch.sigmoid(want)).abs().max().item()
        k2_err = max(k2_err, err, err_p)
        if err > 2e-5 or err_p > 2e-5:
            raise AssertionError(f"dense_forest D={depth} F={n_feat} "
                                 f"T={n_trees}: max |err| {err:.3g}, "
                                 f"sigmoid {err_p:.3g}")
        if n_feat == WIDE_F:
            wide[depth, n_trees] = (ens, x)
    k2_wide = {}
    for (depth, n_trees), (e, x) in wide.items():
        for rows in (1058, TRAIN_ROWS[0]):
            xr = x[:rows].contiguous()
            bound = forest_bound(rows, WIDE_F, n_trees, depth)
            k2_wide[f"n{rows}_T{n_trees}_D{depth}"] = {
                "ms": device_ms(lambda: raw_predict(e, xr, apply_sigmoid=True)),
                "plain_ms": device_ms(lambda: torch.sigmoid(
                    dense_predict_reference(e.feat, e.thr, e.leaf, xr, depth,
                                            e.base_score, e.tree_scale))),
                "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}
    ens = model.ensemble

    def forest_ms(z):
        return (device_ms(lambda: raw_predict(ens, z, apply_sigmoid=True)),
                device_ms(lambda: torch.sigmoid(dense_predict_reference(
                    ens.feat, ens.thr, ens.leaf, z, ens.depth, ens.base_score,
                    ens.tree_scale))))

    k2_ms, k2_plain_ms = forest_ms(packed_project(random_words, w, c0))
    k2_fp_ms, k2_fp_plain_ms = forest_ms(packed_project(fp_words, w, c0))
    k2_bound = forest_bound(CHUNK, w.shape[1], ens.feat.shape[0], ens.depth)
    print(f"[3 dense_forest_predict] N=16384, (D, F, T) in {cases}, +inf "
          f"thresholds: max |err| {k2_err:.3g} (atol 2e-5) | F=30, T=300, "
          f"D=6: z of the random words kernel {k2_ms:.4f} ms, plain "
          f"{k2_plain_ms:.4f} ms; z of the fingerprints kernel "
          f"{k2_fp_ms:.4f} ms, plain {k2_fp_plain_ms:.4f} ms; bound "
          f"{k2_bound['bound_ms']:.5f} ms ({k2_bound['bound_by']}) | F={WIDE_F} "
          f"(rows, trees, depth; kernel / plain / bound ms): " + "; ".join(
              f"{k} {t['ms']:.4f} / {t['plain_ms']:.4f} / {t['bound_ms']:.5f}"
              for k, t in k2_wide.items()), flush=True)

    # -- phase 4: the slice --------------------------------------------------
    smiles = synthetic_smiles(SLICE_N, seed=1)
    bad_at = (10, SLICE_N // 2, SLICE_N + 2)
    for pos, bad in zip(bad_at, INVALID):
        smiles.insert(pos, bad)
    mols = [(s, f"M{i:06d}") for i, s in enumerate(smiles)]
    with tempfile.TemporaryDirectory() as tmp:
        gpu_csv = os.path.join(tmp, "cuda.csv")
        cpu_csv = os.path.join(tmp, "cpu.csv")
        packed_project.launches.reset()
        raw_predict.launches.reset()
        stats = screen(model, iter(mols), out_csv=gpu_csv, chunk_size=CHUNK,
                       dispatch_workers=2, device="cuda")
        launches = {"packed_project": packed_project.launches.count,
                    "dense_forest_predict": raw_predict.launches.count}
        gpu_rows = read_csv(gpu_csv)
        with open(gpu_csv, "rb") as f:
            one_card_csv = f.read()
        mism, n_near, worst = screen_against_cpu(model, state["ensemble"], mols,
                                                 gpu_csv, cpu_csv)
    if len(gpu_rows) != len(mols) or stats.n_molecules != len(mols):
        raise AssertionError(f"{len(gpu_rows)} rows for {len(mols)} molecules")
    invalid = [i for i, r in enumerate(gpu_rows) if r[2] == "invalid"]
    if invalid != list(bad_at) or stats.n_invalid != len(bad_at):
        raise AssertionError(f"invalid rows {invalid}, expected {list(bad_at)}")
    if [r[:2] for r in gpu_rows] != [[m[1], m[0]] for m in mols]:
        raise AssertionError("CSV rows are not in input order")
    proba = np.array([float(r[3]) for r in gpu_rows if r[2] != "invalid"])
    if not (np.isfinite(proba).all() and (proba >= 0).all() and (proba <= 1).all()):
        raise AssertionError("probabilities outside [0, 1]")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel was not launched by screen(): {launches}")
    print(f"[4 slice] screen(cuda) {stats.n_molecules} molecules "
          f"({stats.n_invalid} invalid), chunk {CHUNK}, 2 dispatchers: "
          f"{stats.mol_per_s:.1f} mol/s (wall {stats.wall_s:.3f} s, featurize "
          f"{stats.featurize_s:.3f} s) on {card} | launches {launches} | "
          f"first {PREFIX} vs screen(cpu): {len(mism)} rows differ, all "
          f"near ties ({n_near} near-tie rows), max |dProbability| "
          f"{worst:.3g} (limit 1e-4)", flush=True)
    sharded = cards_phase(model, mols, one_card_csv)

    # -- phase 5: the trainer's kernels against their plain versions --------
    t5 = time.time()
    k5_err, k5_cases, k5_grad_cases = 0.0, 0, 0
    held = {"k3_err": 0.0, "k3_err_plain": 0.0, "k4_err": 0.0, "k4_calls": 0,
            "k4_near": 0, "k3_cases": 0, "routed_sorts": 0, "routed_leaves": 0}
    feats = (1, 30, 167, 300, WIDE_F)
    for n in (1, 7809, 65536):
        for n_feat in feats:
            for level in (0, 5, 9):
                xb, pos, g, h = level_case(n, n_feat, level, n + n_feat + level,
                                           cuda)
                hold_level(tr, f"n={n} F={n_feat} level {level}", xb, pos, g, h,
                           (xb.amax(0) + 1).to(torch.uint8), 1 << level, rng, held)
        for n_leaves in (1, 64, 1024):
            k5_cases += 1
            _, pos, g, h = level_case(n, 1, 0, n + n_leaves, cuda)   # 20% weigh 0
            pos = torch.randint(0, n_leaves, (n,), dtype=torch.int32, device=cuda)
            start = torch.randn(n, device=cuda)
            bounds = tr.gradient_bounds(g, h)
            p_k, p_again, p_64, p_fix = (start.clone(), start.clone(),
                                         start.double(), start.clone())
            leaf_k = tr.leaf_values(pos, g, h, n_leaves, 1.0, 0.1, p_k)
            leaf_again = tr.leaf_values(pos, g, h, n_leaves, 1.0, 0.1, p_again)
            leaf_fix = tr.leaf_values_fixed_reference(pos, g, h, n_leaves, 1.0, 0.1,
                                                      p_fix, bounds)
            leaf_64 = tr.leaf_values_reference(pos, g.double(), h.double(),
                                               n_leaves, 1.0, 0.1, p_64)
            torch.cuda.synchronize()
            if not (torch.equal(leaf_k, leaf_again) and torch.equal(p_k, p_again)):
                raise AssertionError(f"leaf_values n={n}: two runs differ")
            if not (torch.equal(leaf_k, leaf_fix) and torch.equal(p_k, p_fix)):
                raise AssertionError(f"leaf_values n={n} L={n_leaves}: not its "
                                     f"fixed-point plain version")
            leaf_err = (leaf_k.double() - leaf_64).abs()
            pred_err = (p_k.double() - p_64).abs()
            if bool((leaf_err > 5e-7 * leaf_64.abs() + 1e-9).any()) or bool(
                    (pred_err > 1e-6 * (p_64.abs() + leaf_64[pos.long()].abs())
                     + 1e-9).any()):
                raise AssertionError(f"leaf_values n={n} L={n_leaves}: max |err| "
                                     f"leaf {float(leaf_err.max()):.3g}, margins "
                                     f"{float(pred_err.max()):.3g}")
            k5_err = max(k5_err, float(leaf_err.max()), float(pred_err.max()))
            if n_leaves > 1:                    # K5 routes the last level's split
                xb9 = level_case(n, 9, 0, n + n_leaves, cuda)[0]
                hold_routed_leaves(tr, f"n={n} L={n_leaves}", xb9, pos // 2, g, h,
                                   n_leaves, start, bounds, rng, held)
            # the next tree's gradients from the same launch, against the
            # torch ops on the same margins, draws and weights (some 0)
            for task, sub in (("reg", 1.0), ("reg", 0.8), ("cls", 1.0), ("cls", 0.8)):
                y = (torch.randn(n, device=cuda) if task == "reg"
                     else (torch.rand(n, device=cuda) < 0.4).float())
                u = torch.rand(n, device=cuda)
                w = (torch.rand(n, device=cuda) > 0.2).float()
                p_n, p_ref = start.clone(), start.clone()
                got = tr.leaf_values(pos, g, h, n_leaves, 1.0, 0.1, p_n, bounds,
                                     tr.NextTree(y, u, sub, w, task))
                tr.leaf_values_fixed_reference(pos, g, h, n_leaves, 1.0, 0.1, p_ref,
                                               bounds)
                want = tr.next_gradients_reference(p_ref, y, u, sub, w, task)
                torch.cuda.synchronize()
                k5_grad_cases += 1
                if not (torch.equal(got[0], leaf_fix) and torch.equal(p_n, p_ref)
                        and all(torch.equal(a, b) for a, b in zip(got[1:], want))):
                    raise AssertionError(
                        f"leaf_values with the next tree n={n} L={n_leaves} {task} "
                        f"subsample {sub}: g, h, bounds differ from the torch ops by "
                        f"{[ulp_gap(a, b) for a, b in zip(got[1:], want)]} ulp")
                if n_leaves > 1:
                    hold_routed_leaves(tr, f"n={n} L={n_leaves} {task} {sub}", xb9,
                                       pos // 2, g, h, n_leaves, start, bounds, rng,
                                       held, tr.NextTree(y, u, sub, w, task))

    # features of 1, 2, 3 and 64 occupied bins in one matrix, skewed nodes;
    # every row in one node of level 9; rows that all weigh 0 (or nearly all)
    mixed = [(n, n_feat, level, False, 0.2) for n, n_feat in
             ((7809, WIDE_F), (7809, TRAIN_F), (65536, 167)) for level in (0, 5, 9)]
    mixed += [(7809, WIDE_F, 9, True, 0.2), (65536, TRAIN_F, 9, True, 0.0),
              (7809, WIDE_F, 5, False, 1.0), (7809, TRAIN_F, 9, False, 0.97)]
    for n, n_feat, level, one_node, zero_share in mixed:
        *arrays, counts = mixed_level_case(n + n_feat + level, n, n_feat, level,
                                           one_node, zero_share)
        xb, pos, g, h, n_bins = (torch.from_numpy(a).to(cuda)
                                 for a in (*arrays, counts))
        hold_level(tr, f"mixed bins n={n} F={n_feat} level {level} one_node="
                   f"{one_node} zero share {zero_share}", xb, pos, g, h, n_bins,
                   1 << level, rng, held)
    low = n_bins.clone()
    low[2] = 1                                  # feature 2 fills 64 bins
    try:
        tr.level_histogram(xb, pos, g, h, 1 << level, None, low)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("level_histogram took an n_bins below an occupied bin")
    k3_err, k3_err_plain, k4_err = held["k3_err"], held["k3_err_plain"], held["k4_err"]
    k4_calls, k4_near, k3_cases = held["k4_calls"], held["k4_near"], held["k3_cases"]
    routed_sorts, routed_leaves = held["routed_sorts"], held["routed_leaves"]

    timed = {}
    shapes = [(n, TRAIN_F, tuple(range(TRAIN_DEPTH))) for n in TRAIN_ROWS]
    shapes.append((TRAIN_ROWS[0], WIDE_F, WIDE_LEVELS))
    for n, n_feat, shape_levels in shapes:
        every = torch.ones(n_feat, dtype=torch.bool, device=cuda)
        for level in shape_levels:
            nodes = 1 << level
            xb, pos, g, h = level_case(n, n_feat, level, level, cuda)
            bounds = tr.gradient_bounds(g, h)      # once a tree in a fit
            n_bins = (xb.amax(0) + 1).to(torch.uint8)       # as is a fit's n_bins
            tr.check_bin_counts(n_bins, xb)
            hist = tr.level_histogram(xb, pos, g, h, nodes, bounds, n_bins,
                                      bins_checked=True)
            index_add = index_add_call(xb, pos, g, h, nodes)
            keys = (pos.long()[:, None] * (n_feat * 64)
                    + torch.arange(n_feat, device=cuda)[None, :] * 64
                    + xb.long()).reshape(-1)
            wg = g[:, None].expand(n, n_feat).reshape(-1)
            wh = h[:, None].expand(n, n_feat).reshape(-1)
            length = nodes * n_feat * 64
            timed[n, n_feat, level] = {
                "k3": device_ms(lambda: tr.level_histogram(
                    xb, pos, g, h, nodes, bounds, n_bins, bins_checked=True)),
                "k3_plain": device_ms(lambda: tr.level_histogram_reference(
                    xb, pos, g, h, nodes)),
                "k3_library": device_ms(index_add),
                "k3_bincount": event_ms(lambda: (
                    torch.bincount(keys, weights=wg, minlength=length),
                    torch.bincount(keys, weights=wh, minlength=length))),
                "k3_bound": level_histogram_bound(n, n_feat, nodes),
                "k4": device_ms(lambda: tr.best_splits(hist, every, 1.0, 1.0, False)),
                "k4_plain": device_ms(lambda: tr.best_splits_reference(
                    hist, every, 1.0, 1.0, False)),
                "k4_oblivious": device_ms(lambda: tr.best_splits(
                    hist, every, 1.0, 1.0, True)),
                "k4_oblivious_plain": device_ms(lambda: tr.best_splits_reference(
                    hist, every, 1.0, 1.0, True)),
                "k4_bound": best_splits_bound(nodes, n_feat),
            }
            if level and n_feat == TRAIN_F:     # the sort routing the level before
                timed[n, n_feat, level].update(time_routed_sort(
                    tr, xb, g, h, bounds, n_bins, level, n + level))
        if n_feat != TRAIN_F:
            continue
        leaf_pos = torch.randint(0, 1 << TRAIN_DEPTH, (n,), dtype=torch.int32,
                                 device=cuda)
        timed[n, "k5"] = time_leaf_values(tr, leaf_pos, g, h, 1 << TRAIN_DEPTH,
                                          bounds, xb)
    n = TRAIN_ROWS[0]                          # rf: 1,024 leaves
    xb, _, g, h = level_case(n, TRAIN_F, 0, 10, cuda)
    leaf_pos = torch.randint(0, 1024, (n,), dtype=torch.int32, device=cuda)
    timed[n, "k5_1024"] = time_leaf_values(tr, leaf_pos, g, h, 1024,
                                           tr.gradient_bounds(g, h), xb)

    def levels(n, key, field=None, n_feat=TRAIN_F):
        return [timed[n, n_feat, lv][key][field] if field
                else timed[n, n_feat, lv][key]
                for lv in (range(TRAIN_DEPTH) if n_feat == TRAIN_F else WIDE_LEVELS)]

    def leaf_line(t):
        return (f"{t['k5']:.4f}, plain {t['k5_plain']:.4f}, bound "
                f"{t['k5_bound']['bound_ms']:.6f}; with the next tree's gradients "
                f"{t['k5_next']:.4f}, plain {t['k5_next_plain']:.4f}, bound "
                f"{t['k5_next_bound']['bound_ms']:.6f}; with the next tree and "
                f"routing {t['k5_next_routed']:.4f}, bound "
                f"{t['k5_next_routed_bound']['bound_ms']:.6f}")

    def routed_levels(n, key, field=None):
        return [timed[n, TRAIN_F, lv][key][field] if field else timed[n, TRAIN_F, lv][key]
                for lv in range(1, TRAIN_DEPTH)]

    for n in TRAIN_ROWS:
        print(f"[5 trainer kernels] n={n}, F={TRAIN_F}, levels 0-5 (ms): "
              f"level_histogram {fmt(levels(n, 'k3'))}, plain "
              f"{fmt(levels(n, 'k3_plain'))}, index_add_ "
              f"{fmt(levels(n, 'k3_library'))}, bincount x2 "
              f"{fmt(levels(n, 'k3_bincount'))}, bound "
              f"{fmt(levels(n, 'k3_bound', 'bound_ms'))}; best_splits "
              f"{fmt(levels(n, 'k4'))}, plain {fmt(levels(n, 'k4_plain'))}, "
              f"oblivious {fmt(levels(n, 'k4_oblivious'))}, plain "
              f"{fmt(levels(n, 'k4_oblivious_plain'))}, "
              f"bound {fmt(levels(n, 'k4_bound', 'bound_ms'))}; levels 1-5 with "
              f"the routing of the level before in the sort "
              f"{fmt(routed_levels(n, 'k3_routed'))} against the same K3 alone "
              f"{fmt(routed_levels(n, 'k3_alone'))} (pos restored, the copy taken off): "
              f"added {fmt(routed_levels(n, 'k3_routing'))}, bound "
              f"{fmt(routed_levels(n, 'k3_routing_bound', 'bound_ms'))}; leaf_values "
              f"(64 leaves) {leaf_line(timed[n, 'k5'])}", flush=True)
    head = TRAIN_ROWS[0]

    def wide_levels(key, field=None):
        return fmt(levels(head, key, field, WIDE_F))

    print(f"[5 trainer kernels] n={head}, F={WIDE_F}, levels {WIDE_LEVELS} (ms): "
          f"level_histogram {wide_levels('k3')}, plain {wide_levels('k3_plain')}, "
          f"index_add_ {wide_levels('k3_library')}, bincount x2 "
          f"{wide_levels('k3_bincount')}, bound "
          f"{wide_levels('k3_bound', 'bound_ms')}; best_splits "
          f"{wide_levels('k4')}, plain {wide_levels('k4_plain')}, oblivious "
          f"{wide_levels('k4_oblivious')}, plain "
          f"{wide_levels('k4_oblivious_plain')}, bound "
          f"{wide_levels('k4_bound', 'bound_ms')}; leaf_values (1,024 leaves) "
          f"{leaf_line(timed[head, 'k5_1024'])}", flush=True)
    print(f"[5 trainer kernels] {k3_cases} (n, F, level) cases, F in {feats}, "
          f"{len(mixed)} of them with features of 1, 2, 3 and 64 occupied bins "
          f"(skewed nodes, one node holding every row of level 9, all rows of "
          f"weight 0): level_histogram bit-equal to its fixed-point plain "
          f"version with and without n_bins, max "
          f"|err| {k3_err:.3g} against the exact sum (limit 2.4e-7 |sum| + "
          f"1e-9 n max|v|), {k3_err_plain:.3g} against the plain f32 sum, "
          f"two runs bit-identical, a low n_bins refused ({refused}); "
          f"best_splits {k4_calls} calls (per node and oblivious, column masks, "
          f"the best feature masked out, no valid split) equal to the "
          f"plain version but {k4_near} counted near-tie nodes (max |dscore| "
          f"{k4_err:.3g}); leaf_values {k5_cases} cases (n in 1 / 7,809 / "
          f"65,536, 1 / 64 / 1,024 leaves, 20% of rows of weight 0) bit-equal "
          f"to its fixed-point plain version, max |err| {k5_err:.3g} against "
          f"the float64 sums (limit 5e-7 |leaf|, 1e-6 of the margin terms), "
          f"two runs bit-identical; with the next tree ({k5_grad_cases} cases: "
          f"reg and cls, subsample 1 and 0.8, weights 0 and 1) g, h and "
          f"bounds bit-equal to the torch ops; the routing: {routed_sorts} sorts of "
          f"the next level given each case's split (positions and the tree's pairs "
          f"equal to route_rows_reference, each node's rows as a set, the histogram "
          f"bit-equal to the fixed-point plain version on the routed rows) and "
          f"{routed_leaves} K5 calls given the last level's split (bit-equal to "
          f"route_rows_reference then the fixed-point plain version, pos unchanged); "
          f"{time.time() - t5:.1f} s on {card}", flush=True)

    # -- phase 6: training the screening model --------------------------------
    smiles, labels = labelled_training_set()
    trainer_counters = {"forest_level_histogram": tr.level_histogram,
                        "forest_best_splits": tr.best_splits,
                        "forest_leaf_values": tr.leaf_values,
                        "forest_draws": tr.forest_draws,
                        "forest_level_splits_lanes": tr.level_splits_lanes,
                        "forest_level_splits_oblivious_lanes":
                            tr.level_splits_oblivious_lanes,
                        "forest_level_histogram_lanes": tr.level_histogram_lanes,
                        "forest_leaf_values_lanes": tr.leaf_values_lanes}
    for counter in trainer_counters.values():
        counter.launches.reset()
    torch.cuda.synchronize()
    t0 = time.time()
    trained = ScreeningModel.train(smiles, labels, device="cuda")
    torch.cuda.synchronize()
    train_s = time.time() - t0
    train_launches = {name: c.launches.count for name, c in trainer_counters.items()}
    # a level is K3 then K4 (the routing rides in the next level's sort and
    # in K5), a tree one K5 and two K9 launches (its columns, the next tree's
    # subsample; the first tree's subsample before the loop): the graph's
    # replays count their tree's launches
    want_launches = {"forest_level_histogram": N_TREES * TRAIN_DEPTH,
                     "forest_best_splits": N_TREES * TRAIN_DEPTH,
                     "forest_leaf_values": N_TREES,
                     "forest_draws": 2 * N_TREES + 1,
                     "forest_level_splits_lanes": 0,
                     "forest_level_splits_oblivious_lanes": 0,
                     "forest_level_histogram_lanes": 0, "forest_leaf_values_lanes": 0}
    if train_launches != want_launches:
        raise AssertionError(f"ScreeningModel.train launches {train_launches}, "
                             f"expected {want_launches}")
    twice = ScreeningModel.train(smiles, labels, device="cuda")
    for key in ("feat", "thr", "leaf"):
        if not torch.equal(getattr(trained.ensemble, key),
                           getattr(twice.ensemble, key)):
            raise AssertionError(f"two cuda fits with one seed differ in {key}")
    same_projection = all(np.array_equal(getattr(trained, k), getattr(twice, k))
                          for k in ("scaler_mean", "scaler_scale", "pca_mean",
                                    "pca_components"))

    x_fp, bad = fingerprints(smiles, "morgan", 2048)
    if bad:
        raise AssertionError(f"labelled set holds invalid SMILES {bad[:5]}")
    x_dev = torch.from_numpy(x_fp).to(cuda)
    z = ((x_dev - torch.from_numpy(trained.scaler_mean).to(cuda))
         / torch.from_numpy(trained.scaler_scale).to(cuda)
         - torch.from_numpy(trained.pca_mean).to(cuda)
         ) @ torch.from_numpy(trained.pca_components).to(cuda).T
    proba = raw_predict(trained.ensemble, z.contiguous(), apply_sigmoid=True)
    train_acc = float(((proba > 0.5).cpu().numpy() == labels).mean())
    majority = max(labels.mean(), 1 - labels.mean())
    if not train_acc > majority:
        raise AssertionError(f"training accuracy {train_acc:.4f} is not above "
                             f"the majority share {majority:.4f}")

    z_np = z.cpu().numpy()
    # the host's calls that enqueue device work in one fit of the default
    # model's forest (torch_train_profile.py's fit)
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        GBDTClassifier(n_estimators=N_TREES, learning_rate=0.1, max_depth=TRAIN_DEPTH,
                       subsample=0.8, seed=42, device="cuda").fit(z_np, labels)
        torch.cuda.synchronize()
    fit_calls = host_launch_calls(prof)
    del prof
    kw = dict(n_estimators=N_TREES, learning_rate=0.1, max_depth=TRAIN_DEPTH,
              subsample=1.0, seed=42)
    torch.cuda.synchronize()
    t0 = time.time()
    on_cuda = GBDTClassifier(device="cuda", **kw).fit(z_np, labels)
    cuda_fit_s = time.time() - t0
    t0 = time.time()
    on_cpu = GBDTClassifier(device="cpu", **kw).fit(z_np, labels)
    cpu_fit_s = time.time() - t0
    fit_kw = dict(task="cls", lam=1.0, min_child=1.0, learning_rate=0.1,
                  base_score=on_cpu.ensemble_.base_score, tol=1e-5)
    cuda_state = on_cuda.ensemble_.to_state()
    cmp = compare_gbdt_fits(z_np, labels, on_cpu.ensemble_.to_state(),
                            cuda_state, **fit_kw)
    audit = compare_gbdt_fits(z_np, labels, None, cuda_state, **fit_kw)
    n_nodes = N_TREES * ((1 << TRAIN_DEPTH) - 1)
    if not (cmp.ok and audit.ok) or audit.near_ties > 0.01 * n_nodes or \
            audit.max_leaf_diff > 1e-4:
        raise AssertionError(f"GBDTClassifier cuda vs cpu: {cmp}; along the "
                             f"cuda fit's own splits: {audit}")

    # molecules the fit has not seen: a trained model's thresholds are the z
    # of training molecules, so a repeated fingerprint sits on a threshold
    seen = {row.tobytes() for row in fingerprints_packed(smiles)[0]}
    stream6 = synthetic_smiles(2 * CHUNK, seed=3)
    fresh6 = [row.tobytes() not in seen for row in fingerprints_packed(stream6)[0]]
    smiles6 = [s for s, new in zip(stream6, fresh6) if new][:CHUNK + 500]
    smiles6.insert(7, INVALID[0])
    mols6 = [(s, f"T{i:06d}") for i, s in enumerate(smiles6)]
    with tempfile.TemporaryDirectory() as tmp:
        gpu_csv = os.path.join(tmp, "cuda.csv")
        stats6 = screen(trained, iter(mols6), out_csv=gpu_csv, chunk_size=8192,
                        device="cuda")
        rows6 = read_csv(gpu_csv)
        mism6, near6, worst6 = screen_against_cpu(
            trained.to("cpu"), trained.ensemble.to_state(), mols6, gpu_csv,
            os.path.join(tmp, "cpu.csv"))
    if len(smiles6) != CHUNK + 501:
        raise AssertionError(f"{len(smiles6)} molecules not in the training set")
    if len(rows6) != len(mols6) or rows6[7][2] != "invalid":
        raise AssertionError("screen() with the trained model lost rows")
    problems6 = []
    if fit_calls / N_TREES > MAX_CALLS_A_TREE:
        problems6.append(f"the forest fit's host launch calls {fit_calls / N_TREES:.2f} "
                         f"a tree, above {MAX_CALLS_A_TREE}")
    t_graph = time.time()
    graph_held = graph_holds(tr, z_np, labels, problems6)
    t_graph = time.time() - t_graph
    stochastic = stochastic_holds(z_np, labels, problems6)
    t_draws = time.time()
    k9 = draws_holds(tr, problems6)
    t_draws = time.time() - t_draws
    print(f"[6 train] ScreeningModel.train(cuda) on {len(smiles)} molecules "
          f"(Morgan 2048, PCA 30, {N_TREES} trees of depth {TRAIN_DEPTH}, "
          f"subsample 0.8): {train_s:.3f} s wall | launches {train_launches} | "
          f"a second fit grew the same trees (scaler and PCA identical: "
          f"{same_projection}) | host launch calls of its forest fit "
          f"{fit_calls} ({fit_calls / N_TREES:.2f} a tree, the trees after the first a "
          f"replayed CUDA graph) | training "
          f"accuracy {train_acc:.4f}, majority "
          f"share {majority:.4f} | GBDTClassifier(subsample=1) on z: cuda "
          f"{cuda_fit_s:.3f} s, cpu {cpu_fit_s:.3f} s wall; against the cpu "
          f"fit: {cmp.trees_compared} trees equal ({cmp.equal} nodes equal, "
          f"{cmp.equivalent} equivalent), first near tie at "
          f"{cmp.first_near_tie}, max |dleaf| {cmp.max_leaf_diff:.3g}; along "
          f"the cuda fit's own splits, all {audit.trees_compared} trees: "
          f"{audit.equal} nodes equal to the plain best split, "
          f"{audit.equivalent} equivalent, {audit.near_ties} near ties (limit "
          f"1%), max |dleaf| {audit.max_leaf_diff:.3g} (limit 1e-4) | "
          f"screen(cuda) with the trained model on molecules not in the "
          f"training set ({fresh6.count(False)} of {len(stream6)} drawn were "
          f"dropped) {stats6.mol_per_s:.1f} mol/s, first {PREFIX} vs cpu: "
          f"{len(mism6)} rows differ, all near ties ({near6} near-tie rows, "
          f"limit 1%), max |dProbability| {worst6:.3g}", flush=True)
    print(f"[6 graph] every tree after the first a replayed CUDA graph: gbdt (subsample "
          f"0.8, colsample 0.6), oblivious and rf (depth 10), {GRAPH_TREES} trees, one "
          f"fit and 3 lanes, margins, trees, thresholds and leaves bit-equal to "
          f"graph=False, launches the same (the graph's: "
          f"{ {f'{k[0]} {k[1]}': {n: c for n, c in v.items() if c} for k, v in graph_held.items()} }); "
          f"{t_graph:.1f} s | stochastic fits card against cpu on the same keyed draws: "
          + " | ".join(
              f"{name} ({'GBDTClassifier(subsample=0.8, colsample=0.6), ' + str(N_TREES_STOCHASTIC) if name == 'gbdt' else 'RandomForestClassifier, ' + str(RF_AUDIT_TREES)} "
              f"trees): {h['cmp'].trees_compared} trees equal to the cpu fit "
              f"({h['cmp'].equal} nodes equal, {h['cmp'].equivalent} equivalent, first "
              f"near tie at {h['cmp'].first_near_tie}, max |dleaf| "
              f"{h['cmp'].max_leaf_diff:.3g}); along its own splits, all "
              f"{h['audit'].trees_compared} trees: {h['audit'].equal} nodes equal to the "
              f"plain best split, {h['audit'].equivalent} equivalent, "
              f"{h['audit'].near_ties} near ties (limit 1%), max |dleaf| "
              f"{h['audit'].max_leaf_diff:.3g} (limit 1e-4); {h['s']:.1f} s"
              for name, h in stochastic.items()), flush=True)
    print(f"[6 draws] forest_draws (K9) bit-equal to its plain version at L = 1 "
          f"(n={TRAIN_ROWS[0]}), {LANES_L} and {DRAW_WIDE_L} (n=8,162), streams "
          f"subsample, columns (F={TRAIN_F}) and poisson, trees 0 and 298 + 1, max "
          f"|d| {max(t['max_abs_err'] for t in k9.values())}; ms (plain "
          f"on the card, bound): "
          + "; ".join(f"L={n_lanes} {stream} {t['ms']:.4f} ({t['plain_ms']:.4f}, "
                      f"{t['bound']['bound_ms']:.5f} {t['bound']['bound_by']})"
                      for (n_lanes, stream), t in k9.items())
          + f" | {t_draws:.1f} s", flush=True)
    if problems6:
        raise AssertionError("phase 6: " + " | ".join(problems6))

    # -- phases 7 and 8: the similarity kernels and the transfer path ---------
    from bbbp_tpu_torch.ops import similarity as sm
    from bbbp_tpu_torch.testing import regression_molecules
    from bbbp_tpu_torch.train.transfer import raw_transfer_features

    reg_smiles, reg_y = regression_molecules()
    counters = {"packed_project": packed_project,
                "dense_forest_predict": raw_predict,
                "forest_level_histogram": tr.level_histogram,
                "forest_best_splits": tr.best_splits,
                "forest_leaf_values": tr.leaf_values,
                "forest_draws": tr.forest_draws,
                "tanimoto_topk": sm.tanimoto_topk_packed,
                "tanimoto_gram": sm.tanimoto_gram, "minmax_gram": sm.minmax_gram,
                "forest_level_histogram_lanes": tr.level_histogram_lanes,
                "forest_best_splits_lanes": tr.best_splits_lanes,
                "forest_level_splits_lanes": tr.level_splits_lanes,
                "forest_level_splits_oblivious_lanes": tr.level_splits_oblivious_lanes,
                "forest_leaf_values_lanes": tr.leaf_values_lanes}
    with tempfile.TemporaryDirectory() as cache:
        t0 = time.time()
        aux_raw = raw_transfer_features(smiles, cache_dir=cache)
        reg_raw = raw_transfer_features(reg_smiles, cache_dir=cache)
        print(f"[7 featurize] descriptors, MACCS and Morgan counts of "
              f"{len(smiles)} + {len(reg_smiles)} molecules (Python featurizer "
              f"over {os.cpu_count()} cores, MACCS from C++): "
              f"{time.time() - t0:.3f} s wall", flush=True)
        p7 = similarity_phase(cuda, card, aux_raw, reg_raw)
        wide_audit = wide_fit_audit(card, (smiles, labels), aux_raw)
        transfer_launches, leg_launches = transfer_phase(
            card, counters, (smiles, labels), (reg_smiles, reg_y), reg_raw, cache)

    # -- phase 9: the regressor and train_cv ---------------------------------
    p9 = regressor_phase(card)

    # -- phase 10: the classification ensemble ------------------------------
    p10 = classification_phase(card, counters)
    cls_launches = p10["launches"]

    # -- phases 11, 12 and 13: the regression stack, every other family, then
    # reporting and the utilities, through the same B3DB-format directory
    with tempfile.TemporaryDirectory() as reg_dir:
        reg = regression_phase(card, counters, reg_dir)
        fam = families_phase(card, counters, reg_dir, (smiles, labels),
                             reg["stacked_r2"])
        rep = reporting_phase(card, counters, reg_dir, p9, p10)
    reg_launches = reg["launches"]

    # -- phase 14: the lane-batched forest search -----------------------------
    lanes = lanes_phase(card, counters, p10)

    kernels = [
        {"name": "packed_project", "route": "cuda",
         "source": "bbbp_tpu_torch/csrc/packed_project.cu",
         "replaces": "bbbp_tpu/ops/bitops.py:57",
         "launches": launches["packed_project"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound["bound_ms"], "bound_by": k1_bound["bound_by"],
         "bound_share": k1_bound["bound_ms"] / k1_ms,
         "library_ms": k1_lib_ms,
         "library_call": "torch.addmm(c0, bits, w) on bits already unpacked: "
                         "the product alone, not the same function",
         "ms_fingerprints": k1_fp_ms, "plain_ms_fingerprints": k1_fp_plain_ms,
         "bound_ms_fingerprints": k1_fp_bound["bound_ms"],
         "bound_share_fingerprints": k1_fp_bound["bound_ms"] / k1_fp_ms,
         "launches_regression": reg_launches["packed_project"],
         **{f"launches_{key}_by_card": run["launches"]["packed_project"]
            for key, run in sharded.items()}},
        {"name": "dense_forest_predict", "route": "cuda",
         "source": "bbbp_tpu_torch/csrc/dense_forest.cu",
         "replaces": "bbbp_tpu/ops/forest_tpu.py:85",
         "launches": launches["dense_forest_predict"],
         "launches_transfer": transfer_launches["dense_forest_predict"],
         "launches_classification": cls_launches["dense_forest_predict"],
         "launches_regression": reg_launches["dense_forest_predict"],
         **{f"launches_{key}_by_card": run["launches"]["dense_forest_predict"]
            for key, run in sharded.items()},
         "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound["bound_ms"], "bound_by": k2_bound["bound_by"],
         "bound_share": k2_bound["bound_ms"] / k2_ms, "library_ms": None,
         "ms_fingerprints": k2_fp_ms, "plain_ms_fingerprints": k2_fp_plain_ms,
         "bound_share_fingerprints": k2_bound["bound_ms"] / k2_fp_ms,
         "max_abs_err_fitted_f326": wide_audit["forest_err"],
         "f326": k2_wide},
    ]
    # the trainer's kernels at n = 7,809, F = 30: K3 and K4 at level 5 (the
    # widest level of depth 6), K5 over 64 leaves; every level in *_levels
    head, last = TRAIN_ROWS[0], TRAIN_DEPTH - 1
    train_kernels = (
        ("forest_level_histogram", "k3", "bbbp_tpu/ops/forest_tpu.py:154",
         k3_err, "torch.zeros(...).index_add_(0, keys, (g, h) values), keys and "
         "values made beforehand; bincount: torch.bincount(keys, weights=g) "
         "and (keys, weights=h), timed between events, as it synchronises"),
        ("forest_best_splits", "k4", "bbbp_tpu/ops/forest_tpu.py:125", k4_err,
         None),
        ("forest_leaf_values", "k5", "bbbp_tpu/ops/forest_tpu.py:340", k5_err,
         None))
    for name, key, replaces, err, library in train_kernels:
        t = timed[head, "k5"] if key == "k5" else timed[head, TRAIN_F, last]
        entry = {"name": name, "route": "cuda",
                 "source": "bbbp_tpu_torch/csrc/forest_train.cu",
                 "replaces": replaces, "launches": train_launches[name],
                 "launches_transfer": transfer_launches[name],
                 "launches_classification": cls_launches[name],
                 "launches_regression": reg_launches[name],
                 "max_abs_err": err, "ms": t[key], "plain_ms": t[key + "_plain"],
                 "bound_ms": t[key + "_bound"]["bound_ms"],
                 "bound_by": t[key + "_bound"]["bound_by"],
                 "bound_share": t[key + "_bound"]["bound_ms"] / t[key],
                 "library_ms": t.get(key + "_library")}
        if library:
            entry["library_call"] = library
        if key == "k5":
            entry["shape"] = f"n={head}, 64 leaves"
            entry["ms_n65536"] = timed[65536, "k5"]["k5"]
            entry["plain_ms_n65536"] = timed[65536, "k5"]["k5_plain"]
            deep = timed[head, "k5_1024"]
            entry["ms_1024_leaves"] = deep["k5"]
            entry["plain_ms_1024_leaves"] = deep["k5_plain"]
            entry["bound_ms_1024_leaves"] = deep["k5_bound"]["bound_ms"]
            for suffix, tt in (("", t), ("_1024_leaves", deep)):
                entry["ms_with_next_tree_and_routing" + suffix] = tt["k5_next_routed"]
                entry["bound_ms_with_next_tree_and_routing" + suffix] = \
                    tt["k5_next_routed_bound"]["bound_ms"]
                entry["ms_with_next_tree" + suffix] = tt["k5_next"]
                entry["plain_ms_with_next_tree" + suffix] = tt["k5_next_plain"]
                entry["bound_ms_with_next_tree" + suffix] = tt["k5_next_bound"]["bound_ms"]
            entry["fit_host_launch_calls"] = fit_calls
            entry["fit_host_launch_calls_a_tree"] = fit_calls / N_TREES
            entry["gradient_cases_bit_equal"] = k5_grad_cases
        else:
            entry["shape"] = f"n={head}, F={TRAIN_F}, level {last}"
            if key == "k3":
                for n in TRAIN_ROWS:
                    suffix = "_levels_1_5" + ("" if n == head else f"_n{n}")
                    entry["ms_with_routing" + suffix] = routed_levels(n, "k3_routed")
                    entry["ms_alone" + suffix] = routed_levels(n, "k3_alone")
                    entry["routing_added_ms" + suffix] = routed_levels(n, "k3_routing")
                    entry["routing_bound_ms" + suffix] = routed_levels(
                        n, "k3_routing_bound", "bound_ms")
            for n in TRAIN_ROWS:
                suffix = "_levels" if n == head else f"_levels_n{n}"
                entry["ms" + suffix] = levels(n, key)
                entry["plain_ms" + suffix] = levels(n, key + "_plain")
                entry["bound_ms" + suffix] = levels(n, key + "_bound", "bound_ms")
                if library:
                    entry["library_ms" + suffix] = levels(n, key + "_library")
                    entry["bincount_ms" + suffix] = levels(n, key + "_bincount")
            # the transfer path's width, at levels WIDE_LEVELS
            entry["levels_f326"] = list(WIDE_LEVELS)
            fields = ["", "_plain"] + (
                ["_library", "_bincount", "_no_bins"] if library else []) + (
                ["_oblivious", "_oblivious_plain"] if key == "k4" else [])
            names = {"": "ms", "_plain": "plain_ms", "_library": "library_ms",
                     "_bincount": "bincount_ms", "_no_bins": "ms_without_n_bins",
                     "_oblivious": "ms_oblivious",
                     "_oblivious_plain": "plain_ms_oblivious"}
            for field in fields:
                if field != "_no_bins":
                    entry[names[field] + "_f326_levels"] = levels(
                        head, key + field, n_feat=WIDE_F)
            entry["bound_ms_f326_levels"] = levels(head, key + "_bound",
                                                   "bound_ms", WIDE_F)
            # the same on the aux molecules' own binned rows
            for field in fields:
                if field != "_bincount":
                    entry[names[field] + "_f326_fitted_levels"] = [
                        wide_audit["fitted"][lv][key + field] for lv in WIDE_LEVELS]
        if key != "k5":
            # the regression tree matrix's width, on one fold's own rows
            wide = reg["wide"]
            entry["regression_shape"] = (f"n={wide['rows']}, F={wide['n_feat']}, "
                                         f"levels {list(WIDE_LEVELS)}")
            for field in (("", "_plain", "_library", "_bound") if key == "k3"
                          else ("", "_plain", "_oblivious", "_oblivious_plain",
                                "_bound")):
                name_ = {"": "ms", "_plain": "plain_ms", "_library": "library_ms",
                         "_bound": "bound_ms", "_oblivious": "ms_oblivious",
                         "_oblivious_plain": "plain_ms_oblivious"}[field]
                entry[name_ + "_regression_levels"] = [
                    wide["levels"][lv][key + field] for lv in WIDE_LEVELS]
        if key == "k4":
            entry["near_tie_nodes"] = k4_near
            entry["audit_f326"] = wide_audit["audit"]
            entry["audit_f326_oblivious"] = wide_audit["audit_oblivious"]
            for n in TRAIN_ROWS:
                suffix = "_levels" if n == head else f"_levels_n{n}"
                entry["ms_oblivious" + suffix] = levels(n, "k4_oblivious")
                entry["plain_ms_oblivious" + suffix] = levels(n, "k4_oblivious_plain")
        kernels.append(entry)
    # K9 at the single fit's shape (L = 1, n = 7,809, the subsample's
    # uniforms); every lane count and stream beside it
    main_draw = k9[1, "subsample"]
    entry = {"name": "forest_draws", "route": "cuda",
             "source": "bbbp_tpu_torch/csrc/draws.cu",
             "replaces": "bbbp_tpu/ops/forest_tpu.py:303",
             "launches": train_launches["forest_draws"],
             "launches_transfer": transfer_launches["forest_draws"],
             "launches_classification": cls_launches["forest_draws"],
             "launches_regression": reg_launches["forest_draws"],
             "max_abs_err": max(t["max_abs_err"] for t in k9.values()),
             "ms": main_draw["ms"], "plain_ms": main_draw["plain_ms"],
             "bound_ms": main_draw["bound"]["bound_ms"],
             "bound_by": main_draw["bound"]["bound_by"],
             "bound_share": main_draw["bound"]["bound_ms"] / main_draw["ms"],
             "library_ms": None,
             "shape": f"L=1, n={TRAIN_ROWS[0]}, the subsample's uniforms",
             "fit_host_launch_calls_a_tree": fit_calls / N_TREES,
             "graph_against_eager_launches": {
                 f"{k[0]} {k[1]}": v for k, v in graph_held.items()}}
    for (n_lanes, stream), t in k9.items():
        for field, value in (("ms", t["ms"]), ("plain_ms", t["plain_ms"]),
                             ("bound_ms", t["bound"]["bound_ms"])):
            entry[f"{field}_L{n_lanes}_{stream}"] = value
    kernels.append(entry)
    # the similarity kernels: K6 at the transfer path's shape, K7 and K8 at
    # the full gram of the regression set, d = 2048; other shapes beside
    similarity_kernels = (
        ("tanimoto_topk", "k6", "transfer", "bbbp_tpu/ops/similarity.py:24",
         p7["k6_err"],
         "torch.matmul on bits already unpacked, the epilogue, torch.topk: "
         "orders ties otherwise"),
        ("tanimoto_gram", "k7", "gram_d2048", "bbbp_tpu/ops/similarity.py:60",
         p7["k7_err"], "torch.matmul on bits already unpacked, and the epilogue"),
        ("minmax_gram", "k8", "gram", "bbbp_tpu/ops/similarity.py:106",
         p7["k8_err"], "one torch.matmul of the 16 level indicators stacked to "
         "[N, 16 * 2048], already expanded, and the epilogue"))
    for name, key, main_shape, replaces, err, library in similarity_kernels:
        t = p7["timed"][key, main_shape]
        entry = {"name": name, "route": "cuda",
                 "source": "bbbp_tpu_torch/csrc/similarity.cu",
                 "replaces": replaces,
                 "launches": (transfer_launches if key == "k6" else leg_launches)[name],
                 "launches_legs": leg_launches[name],
                 "launches_regression": reg_launches[name], "max_abs_err": err,
                 "ms": t["ms"], "plain_ms": t["plain_ms"],
                 "bound_ms": t["bound"]["bound_ms"],
                 "bound_by": t["bound"]["bound_by"],
                 "bound_share": t["bound"]["bound_ms"] / t["ms"],
                 "library_ms": t["library_ms"], "library_call": library,
                 "shape": t["shape"]}
        if key in ("k6", "k7"):
            entry["host_launch_calls_a_call"] = p7["launch_calls"][name]
        if key == "k7":
            entry["host_launch_calls_a_weighted_call"] = \
                p7["launch_calls"]["tanimoto_gram_weighted"]
        for (k, shape), other in p7["timed"].items():
            if k != key:
                continue
            suffix = "" if shape == main_shape else "_" + shape
            for field in ("ms", "plain_ms", "library_ms", "ms_weighted",
                          "plain_ms_weighted"):
                if field in other and (suffix or field.endswith("weighted")):
                    entry[field + suffix] = other[field]
            if suffix:
                entry["bound_ms" + suffix] = other["bound"]["bound_ms"]
            if "bound_old" in other:
                entry["bound_ms_old" + suffix] = other["bound_old"]["bound_ms"]
            if "bound_weighted" in other:
                entry["bound_ms_weighted" + suffix] = other["bound_weighted"]["bound_ms"]
        kernels.append(entry)
    kernels += lanes["kernels"]
    for entry in kernels:
        entry["launches_families"] = fam["launches"][entry["name"]]
        entry["launches_reporting"] = rep["launches"][entry["name"]]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {nvidia_smi()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
