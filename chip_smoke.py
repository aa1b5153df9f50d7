"""Smoke run of heat_tpu_torch on one NVIDIA card: ``python3 chip_smoke.py``.

Phases, each of which fails the run by raising:

1. the card: torch version, name and power limit (``nvidia-smi``), the TF32
   switches; float32 products must run in full FP32, so matmul TF32 on is
   a failure;
2. the build of every CUDA kernel from ``heat_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together), with its time and the
   register line of each main-path instantiation;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes and at ragged ones, and against itself on a rerun
   (its cross-block sums run in a fixed order). K1, K2 and K8 run on
   their Hopper kernels (``sketch_sm90.cu``, ``sddmm_sm90.cu``: 3xTF32
   ``wgmma``, TMA-fed) wherever their predicates admit the shape, and there
   the kernels they replace (``sketch.cu``, ``spmm.cu``) run on the same
   inputs under the same limits; K1 and K2 at 1000 x 777 (n % 4 != 0) stay
   on ``sketch.cu``, at 1000 x 776 and 65536 x 8192 take their Hopper
   kernel (K2 also at ℓ = 64, k̂ = 32 and at ℓ = k̂ = 1 on inputs x 1e3, K1
   at l = 1, 25, 32, on inputs x 1e-3 and at 130 x 8); K8 takes d = 4, 60,
   64, 72 and 128 on its Hopper kernel and d = 1 and 30 on ``spmm.cu``; K7
   (``spmm.cu``) takes k = 1, 4 and 64, also on rows whose mask is clear
   holding NaN; every instantiation of K1's Hopper kernel must compile
   without spills;
   R1 (``threefry.cu``, heat_tpu's Threefry stream) draws the main paths'
   operands at full size, each in one launch, held against its plain
   version bit for bit (normals too) at the first and last 2^20 elements:
   the north star's float32 normal A, rank 1's chunk of it drawn split 1
   over 4 ranks (65536 rows of 2048: the outer > 1 path), the KMeans shard
   as chip 4's chunk of BASELINE's 1B x 64 draw (also the 2^20 elements
   across flat index 2^32, the counter's high word), and sort_1gb's
   randint keys;
4. the main paths at full size, each kernel count set to 0 just before
   each call and read just after; every ``ht.random`` draw of a path must
   launch R1 once for its elements (the operands below, the hSVD's
   sketch operators: one launch 2-pass, two one-view; k-means++: k
   launches; the attention q, k, v; MultiheadAttention's two inits):
   - hSVD: ``ht.random.randn(65536, 8192, split=0)`` (the 2.1 GB float32
     per-chip shard of the north-star operation), then
     ``ht.linalg.hsvd_rank(A, 10, compute_sv=True)`` in the 2-pass form
     and with ``single_pass=True`` (K1 and K2 on their Hopper kernels,
     counted apart). The factors must be orthonormal, and
     an exactly rank-8 operand of the same size, and a small one held
     against numpy's SVD, must give their singular values back;
   - KMeans: ``ht.random.randn(15_625_000, 64, split=0)`` (the 4.0 GB
     per-chip shard of BASELINE's 1B x 64 over 64 chips), then 20 Lloyd
     iterations of ``KMeans(8, init="kmeans++")`` and ``predict``. Eight
     well-separated blobs of the same size must be recovered, and a fit
     from one point per blob must equal a Lloyd loop on the plain
     assignment; the reference benchmark's configuration (four spherical
     clusters of 5000 3-D points, k = 4) must be recovered by KMeans,
     KMedians and KMedoids;
   - sort: ``ht.random.randn(134_217_728, split=0)`` (bench.py's
     ``sort_1gb`` size), ``ht.sort`` ascending and descending, whose
     indices must equal torch's stable argsort exactly; ``ht.sort`` of
     262,144 x 512 along axis 1 (the TPU kernel's own 512-element blocks);
     ``ht.unique`` of ``ht.random.randint(0, 1000, ...)`` of the same
     length, with its inverse, and of the float32 array; ``ht.topk(x,
     1000)`` both ways, which must equal the prefix of the sort. Each call
     must launch K4, and a float32 ``ht.sort`` must run nothing on the card
     but K4's kernels and memsets (profiled);
   - sparse: bench.py's ``spmm_1gb`` (16384^2, 16,384 full (8, 128)
     bricks, seed 0x18): ``ht.sparse.sparse_dbcsr_matrix(bsr, split=0) @
     x`` with k = 4 (K7 once), ``ht.sparse.sddmm(S, u, v)`` with d = 64
     (K8 once, on its Hopper kernel, counted apart) and the DCSR form ``sparse_csr_matrix(...) @ x``, each
     against a float64 reference; a card-scale matrix (131072^2,
     1,048,576 bricks, built on the card through the raw constructor),
     ``S @ x`` with k = 1 and 4 and ``sddmm`` with d = 64; bench.py's
     ``pagerank_2m`` (8192 nodes, ~2M edges) through ``ht.graph.pagerank``
     with tol 1e-8, K7 once per iteration, ranks within 1e-6 of a float64
     scipy power iteration;
   - attention: ``ht.nn.ring_attention(q, k, v, causal=True)`` on
     ``ht.random.randn(..., split=2)`` at bench.py's RA rows (4, 8, 4096,
     64) float32 and bf16 and its RAB row (1, 8, 16384, 128) bf16;
     ``ht.nn.functional.scaled_dot_product_attention`` on raw float32
     tensors at RA, not causal, and on bf16 heads of 256 (1, 8, 4096,
     256), causal; ``ht.nn.MultiheadAttention(1024, 8, causal=True,
     dtype=bf16)`` on x (1, 16384, 1024), 8 heads of 128. Each call must
     launch K9 exactly once, every one of them on its Hopper path
     (``attention_sm90.cu``: bf16 at D = 64, 128 and 256, float32 at D =
     64 in 3xTF32), and agree with the plain route (MultiheadAttention: K9
     on its strided heads against the plain version, and its output
     against that o through out_proj);
   - relayout: the packed pivot of bench.py's 1 GB reshape row, (1000,
     250000) float32 split 1 -> (10,000,000, 25) new_split=1 and back,
     planned by the port's planner as heat_tpu plans them at 8 ranks
     (packed-pivot, 9 all-to-alls each), with the executor's per-rank
     bodies of all 8 ranks run in this one process (8 ranks emulated; the
     exchange is a device copy, not NCCL, so the wall time is not a
     distributed timing). Both moves must equal torch.reshape bit for bit,
     issue the plan's collectives, and launch K5 8 times (forward) and K6 8
     times (reverse). Then world size 1 through the public entry points:
     ht.arange(2**27, split=0).sum() equal to its closed form in int64,
     and resplit and reshape(new_split=) of the 1 GB array against
     torch.reshape;
   - the NumPy surface (``surface_path``): on ``ht.random.randn(65536,
     8192, split=0)``, ``A + A``, ``A * 2.0``, ``(A - A.mean(axis=0)) /
     A.std(axis=0)``, ``ht.exp(A)``, ``(A > 0).sum()``, ``abs(A).max()``,
     ``A.argmax(axis=1)``, ``ht.cumsum(A, axis=0)`` and ``A.var()``, each
     against an independent torch formula on the same card tensor (float64
     for the reductions; exactly for integers, comparisons, argmax and the
     extremes; a stated relative tolerance for the rest) and timed under
     CUDA events beside its byte bound (each operand read once, the result
     written once, over 3.35 TB/s); then ``ht.median`` and
     ``ht.percentile(x, [5, 50, 95])`` (linear and nearest) of sort_1gb's
     2^27 float32, each launching K4 and equal to the sorted values'
     interpolation; the rows print as one JSON line, ``{"surface": ...}``,
     before the kernels line;
   - indexing (``indexing_path``): on ``ht.random.randn(65536, 8192,
     split=0)`` (R1), ``A[1000:60000:3, ::2]``, ``A[:, 4097]``, ``A[A >
     2.5]``, ``A[A[:, 0] > 0]``, ``ht.nonzero(A > 3.5)``, ``ht.where(A > 0,
     A, 0.0)``, the gather ``A[idx]`` of ``idx = ht.topk(A[:, 0], 1000)[1]``
     (K4 must launch), the writes ``A[A < -4.0] = 0.0``, ``A[idx] = 0.0``
     and ``A[100:200] = B[:100]``, ``ht.ones``, ``ht.full`` and
     ``ht.linspace`` at the operand's size and ``repr(A)``, each equal to an
     independent torch formula on the card (``linspace`` within float32's
     last bit of ``torch.linspace`` in float64) and timed beside its byte
     bound (what the call must read once plus write once); ``repr(A)``
     with the bytes it copies to the host; a ``{"indexing": ...}`` line;
   - training (``train_path``, BASELINE #5): a float32 ``Conv2d`` at the
     CNN's second layer, forward and backward, within FP32 rounding of the
     CPU's (cuDNN's TF32 off inside the module); 60,000 MNIST-shaped
     images with planted classes written as IDX files, read by
     ``MNISTDataset``, shuffled by a ``DataLoader`` of global batches of
     8192 (R1's permutation); 5 SGD steps of examples/mnist.py's CNN and
     MLP through ``DataParallel`` and ``DataParallelOptimizer``, the loss
     falling, R1 once a dropout layer a step; one step on 256 rows equal to
     the same model and key on the CPU within 1e-4; ms a step beside the
     operations' bound and the card's busy share (profiled);
   - KMedians and KMedoids (``kmedians_path``, BASELINE #4): on
     ``ht.random.randn(15_625_000, 64, split=0)`` with ++ seeding, 10
     iterations, K4 once an iteration (the exact median's one sort), R1
     k times, ms an iteration; eight planted blobs recovered by each;
   - the factorizations (``linalg_path``) at ``heat_tpu``'s golden plan
     shapes: ``polar`` of 65536 x 1024 float32 (its Newton–Schulz steps and
     host reads printed), ``svd`` of it by the qr and polar routes and
     values only (σ against float64 ``gesvd``), ``cholesky``, ``lu``,
     ``solve`` (8192 x 256, both kinds, and the triangular solves alone),
     ``inv`` and ``det`` of 8192² operands (``_linalg_operands``),
     ``eigh`` of a 4096² symmetric matrix, ``cg`` on a 4096² SPD float64
     system to its stop test and ``lanczos`` with m = 64 (R1 once for its
     start vector); each held to a limit (``TOL_*``) and timed beside its
     operation bound;
   - the estimators (``estimators_path``): the five scalers (fit,
     transform, inverse) on ``ht.random.randn(65536, 8192, split=0)``,
     their statistics, the transform of 8192 rows and the round trip within
     ``TOL_EST`` of a float64 pass on the card (the quantiles from ATen's
     sort), K4 under ``RobustScaler``; ``GaussianNB`` fit,
     ``predict_proba`` and ``predict`` on eight blobs of KMeans' shard
     (15,625,000 x 64, label = blob), θ and var within ``TOL_NB`` of
     float64, ``predict``'s peak allocation at most ``NB_PEAK`` x X;
     ``Lasso`` on the same rows with y = Xθ* + noise (8 of 64 coefficients
     non-zero), θ within ``TOL_LASSO`` of NumPy's float64 sweeps on a
     float64 Gram, one host read a sweep; ``KNeighborsClassifier(5)``,
     16384 queries against 65536 training rows, labels equal to a float64
     vote with (distance, index) ties, the distances' share of the call;
     the ``Laplacian`` and ``Spectral(8)`` (``n_lanczos`` 300) of eight
     blobs of 4096 x 64 rows, every blob recovered, K3 once a Lloyd step,
     R1 1 + k times, 299 Lanczos host reads; ``spectral_embedding(k=8,
     m=64)`` of ``pagerank_2m`` symmetrised (A + Aᵀ), K7 1 + m times, Ritz
     values and embedding (up to column signs) within ``TOL_EMB`` of the
     same Lanczos in float64 on K7's plain version; an ``{"estimators":
     ...}`` line;
   - the distributed hSVD as a 4-rank world on this one card
     (``world_path``): 4 spawned workers join a gloo world
     (``init_method=file://``) with every rank's tensors on ``cuda:0``,
     each makes its own 65536 x 8192 float32 shard and declares it with
     ``ht.array(local, is_split=...)``: 262144 x 8192 split 0, 2-pass and
     one-view, 8192 x 262144 split 1, and an exactly rank-8 operand of the
     first size, both forms, each through ``hsvd_rank(A, 10,
     compute_sv=True)``. Every rank must launch K1 (2-pass) or K2
     (one-view), all on the Hopper kernel; U and V must be orthonormal
     across ranks within 1e-4 (the Gram all-reduced), σ positive,
     descending and equal bit for bit on every rank, the rank-8 σ within
     ``RANK8_TOL``. A worker that raises, or a world that does not finish
     within ``WORLD_TIMEOUT_S``, fails the run. The world first draws one
     global ``ht.random.randn(4 x 65536, 8192, split=0)``: each rank must
     launch R1 once for exactly its chunk's elements, issue no collective,
     and hold the chunk of the plain version's draw at its ends; then the
     north star ``randn(65536, 8192, split=1)`` the same way (each rank's
     columns: R1's outer > 1 path). It prints the world's call
     time (CUDA events on rank 0 between barriers) beside the bound of the
     four shards' reads on one card, each rank's level-0 time in the call
     and alone, the one-view copy of Sᵀ alone, and the bytes each rank put
     into each collective; four processes time-share the card and gloo
     crosses the host, so these are not a distributed timing. The same
     world then runs, each rank's shards made on the card from its own
     seed: ``KMeans(8, init="kmeans++")`` for 20 iterations and
     ``predict`` on 15,625,000 x 64 float32 a rank (BASELINE #4 at world
     size 4), where every rank must launch K3 ``n_iter_`` times and hold
     the same centers bit for bit, eight planted blobs (two a rank) must
     be recovered, and a fit from one point per blob must equal a Lloyd
     loop on the plain assignment with the same all-reduce; then
     ``ring_attention`` with q, k and v split 2 at bench.py's RA row
     (float32 causal and not, bf16 causal), its RAB row (bf16 causal) and
     a ragged 4097-token RA (float32 causal), where rank r must launch K9
     r + 1 times causal and 4 times not, all on the Hopper path, and the
     gathered output must agree with the plain version on the whole q, k
     and v; at RA float32 and bf16 causal and the ragged 4097 the ring's
     backward too (``_world_attention_backward``: dQ, dK and dV for a seeded
     output gradient, 4 collective-permutes a rank, the gathered gradients
     within ``TOL_RING_GRAD`` of the plain version's autograd on the whole
     q, k and v, timed beside the forward); then ``cdist(X, ring=True)`` (the half ring),
     ``cdist(X, Y, quadratic_expansion=True, ring=True)`` and ``rbf(X,
     ring=False)`` on 65536 x 64 float32 split 0, each rank's rows within
     1e-5 of the scale of a float64 result on sampled rows and of the
     other route (ring against gather); then the sort family along the
     split axis: ``ht.sort`` of bench.py's ``sort_1gb`` row split 0
     (134,217,728 float32, 2^25 a rank: columnsort) ascending and
     descending, ``ht.topk(x, 1000)`` and ``ht.unique``, ``ht.sort`` of
     2^27 + 2 elements (2^25 + 1 a rank: the odd-even network, 4 rounds),
     and ``ht.unique(X, return_inverse=True, axis=0)`` of (2^22, 4) int32 in
     [0, 8), where each rank must launch K4 once a local step of its
     schedule (both directions), twice in ``topk`` and flat ``unique`` (its
     local pass and its merge) and twice a column in ``unique(axis=0)``, and
     the gathered results must equal ``torch.sort(stable=True)`` and
     ``torch.unique`` on the card (indices bit for bit; the descending sort
     is the flip of the ascending one). Each prints its time beside its
     bound, the collectives and bytes a rank, and the bytes gloo's
     send/receive staged through the host; the sorts also print each
     rank's local steps (``block_sort``) under CUDA events. Last, the
     surface across ranks (``_world_surface``): a 65536 x 8192 operand
     split across the world, A (split 0) + B (split 1) with B resplit,
     ``ht.cumsum(A, 0)`` along the split axis, ``A.mean(0)``, ``A.var(0)``
     and ``A.argmax(axis=0)`` across ranks, and ``ht.median`` of sort_1gb
     split 0 (the distributed sort, K4 a local step), each rank checking its
     part against the whole operand regenerated from the shared seed;
     then indexing across ranks (``_world_indexing``): on a 65536 x 8192
     operand split 0 (and split 1), ``A[A > 2.5]`` and ``ht.nonzero(A >
     3.5)`` (even split-0 chunks), ``A[idx]`` of 1000 rows owned by every
     rank, ``A[12345]``, ``Z[:, 5]`` of the split-1 twin, ``A[A < -4.0] =
     0.0`` and ``repr(A)``, each rank against the whole operand, with its
     collectives and bytes; then training across ranks (``_world_train``):
     the CNN on the global batch of 8192 split 0, 3 SGD steps, every rank's
     parameters equal bit for bit and within 1e-4 of world size 1's, and
     DASO with two nodes of two ranks (equal within a node after its first
     step, all equal after the global sync of its second); last KMedians
     and KMedoids (``_world_kmedians``) on world size 1's 15,625,000 x 64
     draw split over the ranks from ``init="random"``: labels equal to
     world size 1's, centers within 1e-6, K4 once an iteration a rank;
     and the factorizations across ranks (``_world_linalg``): ``polar``
     and ``svd`` of the 65536 x 1024 operand split 0, ``cholesky``,
     ``lu``, ``solve``, ``inv`` of 8192² split 0 and ``det`` split 1,
     ``eigh`` of 2048² (it recurses; R1 twice a spectral split for the
     range probes), each rank's rows held to the same limits, the
     collectives a rank equal to the docstrings' counts, LU's perm equal
     to world size 1's and σ, det and λ equal on every rank; last the
     estimators across ranks (``_world_estimators``) on 1/8 of world size
     1's rows, every rank drawing the operands whole and keeping its
     chunk: the scalers but the Normalizer on 8192 x 8192 split 0 and
     split 1 (statistics within ``TOL_WORLD_EST`` of world size 1's, the
     round trip), GaussianNB (θ, var and labels), Lasso (θ, the same
     sweeps, one all-reduce), KNN (labels equal) and Spectral (labels a
     permutation of world size 1's), each with its time, collectives and
     bytes a rank; then the sparse engine across ranks (``_world_sparse``):
     spmm_1gb's BSR split 0, ``S @ x`` with x whole (no collective) and
     split 0 (one all-gather), ``sddmm(S, u, v)`` at d = 64, the card
     matrix with each rank drawing only its slab on the card
     (``card_slab``), ``S @ x`` at k = 4, ``pagerank_2m`` split 0 (world
     size 1's iteration count, one all-gather to build the slabs and one
     a step) and
     ``spectral_embedding`` of the symmetrised graph as a split DBCSR, each
     held to the same call at world size 1 (K7/K8 within 1e-5 of |A|·|x|,
     PageRank 1e-6, the embedding ``TOL_EMB``), every rank launching K7 (or
     K8, on its Hopper kernel) once a product on its own slab; K7 and K8
     are then timed alone on each rank's slab beside their plain versions
     and the library call, the ``world_*`` kernel rows; last I/O across
     ranks (``_world_io``): ``load_csv(split=0)`` of ``io_path``'s file,
     each rank reading its byte range (two all-gathers), a rank-ordered
     ``save_csv`` whose file equals world size 1's, a checkpoint saved at
     4 ranks and loaded at 4 and at 1 bit for bit, and
     ``OneHotEncoder`` on 2^20 x 8 codes split 0, its DCSR equal to world
     size 1's;
   - I/O (``io_path``): ``ht.save``/``ht.load`` of a split-0 float32
     2^18 x 16 array as CSV (values back bit for bit, the file equal to
     ``np.savetxt``'s), a checkpoint of the CNN's training state (model
     and SGD momentum) and of a 1 GiB split-0 float32 array (bit for
     bit), and ``OneHotEncoder`` on 2^20 x 8 codes, each timed on the host
     clock beside the card's name and power limit; ``supports_hdf5()``
     is printed on a line of its own (the card's machine has no h5py);
   - out of core (``ooc_path``): the north star's 65536 x 8192 float32 as a
     ``HostArray`` in host memory, ``hsvd_rank(A, 10, compute_sv=True)`` in
     both forms through the 256 MiB slab, K1 (2-pass) or K2 (one-view) once
     a column window on its Hopper kernel, held against the in-memory route
     on the same operand (``TOL_OOC``), timed on the host clock with its
     host-to-card rate beside the plain pinned copy rate of the run (its
     bound); with ``HEAT_TPU_HBM_BYTES`` below the operand ``materialize``
     must refuse and the staged route run; ``KMeans.partial_fit`` on a
     ``HostArray`` of a quarter of KMeans' shard (K3 once a window, bit for
     bit the same windows fed from the card), ``pagerank_stream`` on
     pagerank_2m's edges (ranks within ``TOL_RANKS`` of ``pagerank``) and
     ``OneHotEncoder.stream_transform`` of io_path's codes (its ones where
     ``transform`` puts them); an ``{"ooc": ...}`` line;
5. times as medians of CUDA-event readings, each beside its bound: the
   larger of the bytes that must move over 3.35 TB/s and the operations
   over 67 TFLOP/s (FP32 outside the tensor cores), the H100 SXM data-sheet
   peaks; and a profile of one call or fit of each main path. K4 is
   checked for exact equality with its plain version (it moves integers)
   at both regimes' main shapes, ragged and boundary segment lengths, the
   one-sweep tile boundaries and an odd size of 3,000,017, adversarial
   float32 keys, int32 extremes, constant digit places (all-equal keys,
   keys differing only in the top byte, randint(0, 1000)) and n = 1, at
   the local steps of the distributed sort networks (one segment of 2^25
   and of 2(2^25 + 1) pairs, 1000 segments of 3000; keys with heavy ties
   and NaN, the global index as payload ordered by 2 and 4 bytes), and
   on a rerun; its fused entry against the plain composition of the key
   transforms and the pair sort in each transform mode, order and output;
   and one segment of 2^30 pairs against the invariants of a stable sort.
   Its rows time the fused entry the main path launches (values and int64
   indices, bound 16 B a pair) beside torch.sort, the words-only entry and
   the first design of K4 (``pr3_ms``), and the networks' local steps
   alone: ``block_sort`` and its ``pair_sort`` on 2^25 and 2(2^25 + 1)
   (value, index) pairs ordered by 4 index bytes. K7 and K8 are held
   against their plain versions within 1e-5 of each element's absolute-sum
   scale, and against themselves on a rerun bit for bit, at the main-path
   shapes, ragged 1003 x 777, empty brick rows, all-zero and pad bricks,
   an empty matrix and bf16 bricks; K8's row times its Hopper kernel
   beside spmm.cu's (``pr4_ms``, in turns), K1's and K2's beside
   sketch.cu's (``pr1_ms``), K1 beside ``g @ a`` (the library call that
   gives its w alone) and K2 beside the three library calls that compute
   its outputs apart (``composed_ms``: g @ a, a @ omega, a.square().sum();
   context, not a yardstick), both with the 3xTF32 and the FP32 CUDA-core
   operation bounds beside their byte bound; K7's library yardstick is
   PyTorch's sparse tensor of the same matrix, and its rows also carry
   K7's device time (``device_ms``: CUDA events around calls queued behind a
   spin kernel, since a CUDA-event median of one call this short times the
   host's launch); PageRank is timed as its
   host build and its fixpoint. K9 is held against its plain version (float32
   |Δo| ≤ 1e-5 max|v|, |Δlse| ≤ 1e-5 (1 + |lse|); bf16 elementwise |Δo| ≤
   3 · 2^-8 (|o| + the attention of |v|) and |Δlse| ≤ 1e-4 (1 + |lse|)) and
   against itself on a rerun bit for bit, at RA (f32 causal and not, bf16),
   RAB, ragged 1000 x 777 keys with D = 72, D_v = 40, ragged causal 1003,
   causal S_q < S_kv, D = 8, D = 256, S_q = 1, scores scaled by 10 and
   S_kv = 0 (no launch); its Hopper path also at 1000 x 1000 causal and
   not, causal 300 x 1003, S_q = 1 against 4096 keys and scores x 10, each
   at bf16 D = 64, 128 and 256 and at float32 D = 64, and on MHA-1024's
   strided heads, and wherever it runs also against attention.cu's kernel
   on the same inputs (mma.sync for bf16, the FP32 kernel for float32)
   under the same limit, that kernel also against the plain version; the
   float32 cases print the library call's own error against the plain
   version beside K9's; attention.cu on the shapes the Hopper path
   refuses; its lse through the ring's combine of two halves of K/V; on
   the strided heads of a packed projection, bit for bit its result on
   copies; and under autograd (one launch, gradients within 1e-5 of the
   plain version's). Its bound is the operations over 989 TFLOP/s (bf16
   tensor cores) or, for float32, three times the operations over 495
   TFLOP/s (3xTF32 on the tensor cores; the FP32 CUDA-core bound, the
   operations over 67 TFLOP/s, beside it), or the bytes where larger; its
   library yardstick is ``scaled_dot_product_attention`` on the same
   inputs, checked to agree first; at every main shape the Hopper path
   and attention.cu's kernel are timed side by side; the public calls are
   timed end to end and one MultiheadAttention forward is profiled. K5 and K6 are held
   against their plain versions bit for bit (raw words) at the per-rank
   shapes of the 1 GB move over 8 ranks and of (2048, 64) <-> (8192, 16)
   over 4, ragged and degenerate shapes (no rows, p = 1, c_in = c_out),
   64-bit offsets, bool, int8, bf16, float32, float64, complex64 and
   complex128, and float32 NaN payloads and -0.0; their bound is the bytes
   read and written over 3.35 TB/s, and a clone() of the 160 MB buffer
   stands beside them as the card's copy rate; no single PyTorch call pads
   and block-transposes, so ``composed_ms`` times the two calls that do
   (``F.pad`` and a permuted view's ``.contiguous()``, or that and a
   slice's). K8's library yardstick is ``torch.sparse.sampled_addmm`` on a
   CSR mask of S's nonzeros (u·vᵀ there; times S's values it is checked
   against K8's bricks at up to 2^22 of them). R1's rows time its draws at the main shapes
   (a lone call's CUDA events, and ``device_ms`` of queued calls) beside
   the plain version (in pieces of 2^25 elements) and torch's own
   generator on the same shape (context only: another stream, so no
   library yardstick); its bound is the larger of the output written once
   and the operations the draw's function needs (``R1_OPERATIONS``: each
   Threefry block's shifts, xors and adds, the transform's float, integer
   and conversion operations) on the busiest pipe or the issue slots, at
   compute capability 9.0's rates over 132 SMs at the maximum SM clock, the
   adds placed where they cost least; ``bound_pipe`` names the pipe that
   sets it. R1's normal transform is also held bit for bit against its
   plain version on every input a float32, float16 or bfloat16 draw can
   give it (``normal_of_words``).

Q1 (``quant.cu``, the int8 wire codec) is held against its plain version
bit for bit (codes and scale bytes; decode exactly) on the CPU test's cases
and on 2^28 normals. The wire phase (``wire_path``) runs the CNN's SGD
steps with ``wire_quant`` at world size 1 (the exact step: no Q1 launch),
the 1 GB ``reshape_split1_1gb`` move over 8 emulated ranks under
``HEAT_TPU_WIRE_QUANT=1`` flat and at ``HEAT_TPU_TOPOLOGY=2x4`` (Q1 once a
codec step a rank), and times a durable disk commit (the lattice's ``disk``
edge); in the world, ``_world_wire`` trains on the quantized wire flat and
at 2x2 (Q1 two encodes and four decodes a rank a step flat) and runs
``hsvd_rank``, a split ``matmul``, ``polar`` and ``lu`` under
``HEAT_TPU_REDIST_OVERLAP=1`` against their barrier forms. Q1's rows time
encode and decode at 2^28 and at the CNN's gradient blocks beside their
byte bound, the plain version and the bf16 mode's cast.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without CUDA the script
exits with an error and prints no result.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
import warnings

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

M, N = 65536, 8192  # the north-star per-chip shard, float32
MAXRANK = 10
RAGGED = (1000, 777)  # n % 4 != 0: K2 keeps sketch.cu's kernel here
K2_RAGGED_SM90 = (1000, 776)  # ragged rows and columns on K2's Hopper kernel
RANK8_SIGMA = [8.0, 7.0, 6.0, 5.0, 4.0, 3.0, 2.0, 1.0]

# kernel against plain version, both float32 with other summation orders
# over up to 65536 terms: relative Frobenius error of w and y, relative
# error of the norm
TOL_W = 1e-5
TOL_NORM = 1e-6

KM_N, KM_D, KM_K = 15_625_000, 64, 8  # the KMeans per-chip shard (bench.py:114)
KM_ITERS = 20
# K3 against its plain version: cluster sums within relative Frobenius
# error 1e-5 and inertia within relative error 1e-5 (float32 sums in two
# orders); counts exactly equal on well-separated blobs; on Gaussian data
# near-ties may flip labels between the two orders, so Σ|Δcount| ≤ 1e-5·n
TOL_SUMS = 1e-5
TOL_INERTIA = 1e-5
TOL_FLIPS = 1e-5
# (n, d, k) of phase 3: main, the reference benchmark, ragged, and the
# largest k and d the kernel's predicate admits
K3_SHAPES = ((KM_N, KM_D, KM_K), (20000, 3, 4), (1003, 16, 4), (100_003, 124, 64))

SORT_N = 134_217_728  # float32 elements of the sort_1gb row (bench.py:111)
SORT_ROWS, SORT_SEG = 262_144, 512  # 512-element rows: the TPU kernel's own blocks
TOPK_K = 1000
ADV_N = 1 << 22  # adversarial keys, as one segment and as rows of 512

SPARSE_SEED = 0x18  # bench.py's seed of spmm_1gb and pagerank_2m
SPMM_N, SPMM_OCC, SPMM_K = 16384, 0.0625, 4  # spmm_1gb (bench.py:117-122): 16,384 full bricks
SDDMM_D = 64
# d at K8's edges: 4 and 60 take its Hopper kernel below one pass of 64, 72
# and 128 in two passes; 30 (not a multiple of 4) keeps spmm.cu's kernel
K8_EDGE_D = (4, 30, 60, 72, 128)
CARD_N, CARD_BRICKS = 131072, 1 << 20  # 6.25% brick fill: 64 bricks per brick row, 4.29 GB
PR_N, PR_DEG, PR_TOL = 8192, 256, 1e-8  # pagerank_2m (bench.py:123-125)
PR_HEAT_TPU_ITERATIONS = 10  # heat_tpu's count on the CPU (docs/PERF.md:334)
# K7 and K8 against their plain versions, and the sparse path against its
# float64 references: |got - ref| <= 1e-5 * (the sum of the absolute
# terms), elementwise; float32 sums in another order stay within a few
# ulps of that scale (1e-5 is ~80 ulps)
TOL_SPARSE = 1e-5
TOL_RANKS = 1e-6  # PageRank against a float64 power iteration, absolute

BF16_FLOP_PER_S = 989e12  # dense bf16 tensor cores, H100 SXM data sheet
TF32_FLOP_PER_S = 495e12  # dense TF32 tensor cores, the same; 3xTF32 runs each float32 product three times
RA = (4, 8, 4096, 64)  # bench.py's RA_* rows (B, H, S, D), causal (bench.py:103)
RAB = (1, 8, 16384, 128)  # bench.py's RAB_* 16k-token long-context row (bench.py:109)
MHA_E, MHA_H = 1024, 8  # MultiheadAttention at RAB's attention shape: 8 heads of 128
MHA_SEED = 23  # its parameters' key, seed_key(23)

# the random stream's kernel R1 (csrc/threefry.cu)
R1_SOURCE = "heat_tpu_torch/csrc/threefry.cu"
R1_REPLACES = "heat_tpu/core/random.py:67 (_next_key; XLA's threefry2x32, no Pallas kernel)"
R1_SAMPLE = 1 << 20  # elements held against the plain version at each end and across 2^32
KM_GLOBAL_ROWS, KM_CHIP = 1_000_000_000, 4  # BASELINE #4's 1B x 64; chip 4's shard crosses flat index 2^32
#: R1's launches and element counts on each main path's draws, filled by the paths
R1_PATH = {}
SDPA_D256 = (1, 8, 4096, 256)  # bf16 heads of 256 (B, H, S, D), causal: K9's Hopper path at its widest head
# K9 against its plain version. float32: both sides sum float32 terms in
# other orders over up to 16384 keys, and o is a convex combination of v
# rows, so |Δo| <= 1e-5 max|v| of the (b, h) slice and |Δlse| <= 1e-5 (1 +
# |lse|). bfloat16, elementwise: K9 rounds p to bf16 for the second product
# (|Δ| <= 2^-8 A, A the attention of |v|) and both sides round o to bf16
# (2^-8 |o| each), so |Δo| <= 3 · 2^-8 (|ro| + A), which also covers the
# ring's combine of two rounded halves (2 |o| + 3 A); float32 scores and sums
# add ~1e-4 of that. lse stays float32: 1e-4 (1 + |lse|)
TOL_ATT_F32 = 1e-5
TOL_ATT_BF16_O = 3.0
TOL_ATT_BF16_LSE = 1e-4

# K5/K6 move bytes and must equal their plain versions bit for bit
RESHAPE_1GB = ((1000, 250000), (10_000_000, 25))  # bench.py's reshape_split1_1gb row
RELAYOUT_P8 = (1_250_000, 25, 32, 8)  # K5's per-rank (rows, c_in, c_out, p) of that move over 8 ranks
RELAYOUT_WIDE = (67_108_865, 31, 32, 8)  # rows x 32 > 2^31: the kernels' 64-bit index path


# the north star as a 4-rank world on the one card: each rank's shard is the
# per-chip shard above (BASELINE.json), made on the card from its own seed
WORLD = 4
WORLD_TIMEOUT_S = 720  # the workers' limit, from the spawn to the last result
WORLD_REPS = 5
# (name, each rank's shard, split, single_pass, exactly rank 8)
WORLD_CONFIGS = (
    ("split0_2pass", (M, N), 0, False, False),
    ("split0_one_view", (M, N), 0, True, False),
    ("split1_2pass", (N, M), 1, False, False),
    ("rank8_2pass", (M, N), 0, False, True),
    ("rank8_one_view", (M, N), 0, True, True),
    ("rank8_split1_2pass", (N, M), 1, False, True),
)


# kernels whose every instantiation must compile without spills (K1's Hopper kernel)
NO_SPILLS = ("sketch_sm90_kernelILi0ELb0E",)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def _median_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _device_ms(fn, reps: int) -> float:
    """Device time of one ``fn()`` (every kernel it launches): CUDA events
    around ``reps`` calls queued behind a spin kernel (``torch.cuda._sleep``)
    that keeps the card busy while the host submits them, so that the calls
    run back to back and the span leaves out the host's launch, which sets
    the event time of a lone call shorter than about 0.1 ms. The span keeps
    the card's own gap between queued launches (a few microseconds). The
    spin is checked to outlast the submission (the start event has not
    fired when the last call is queued) and lengthened until it does."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    # twice the host's time for the reps calls, at a clock of at most 2 GHz
    cycles = int(4e9 * (time.perf_counter() - t0)) + 1_000_000
    for _ in range(4):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(stop) / reps
        cycles *= 4
    raise RuntimeError("chip_smoke: the spin kernel never outlasted the host's submission of the timed calls")


def _bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _rel(x, ref) -> float:
    return float((x.double() - ref.double()).norm() / ref.double().norm().clamp_min(1e-300))


def card_report() -> str:
    import torch

    print(f"torch {torch.__version__} (CUDA {torch.version.cuda})", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    tf32_mm = torch.backends.cuda.matmul.allow_tf32
    tf32_cudnn = torch.backends.cudnn.allow_tf32
    print(f"allow_tf32: matmul={tf32_mm} cudnn={tf32_cudnn}", flush=True)
    _require(not tf32_mm, "matmul TF32 is on; float32 products must run in full FP32")
    return card


def build_kernels() -> None:
    from heat_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    ready = _build.build_all()
    each = ", ".join(f"{name} ready after {sec:.1f} s" for name, sec in ready.items())
    print(f"kernel build: {time.perf_counter() - t0:.1f} s for {_build.sources()} ({each})", flush=True)
    for name in _build.sources():
        log = _build._library_path(name).with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        # register use and spills (-Xptxas -v) of the main paths'
        # instantiations (K1's and K2's Hopper kernels, K2 at k̂ ≤ 24, and
        # sketch.cu's K1 l=25 and K2 ℓ=59 timed beside them, K3 k ≤ 8, K4's
        # kernels of both regimes (rows of 512: two warps a row), K7 k = 1
        # and 4, K8's
        # Hopper kernel and spmm.cu's timed beside it, K9's Hopper path at
        # bf16 D = 64, 128 and 256 and float32 D = 64, attention.cu's
        # kernels timed beside it (float32 at D_v = 64, mma.sync bf16 at
        # D_v = 256), K5/K6 on 4-byte words with 32-bit offsets, R1's float32
        # normal on contiguous and split-1 chunks, bfloat16 normal and int32
        # randint); and any
        # wgmma that ptxas serialised
        for i, line in enumerate(lines):
            main = ("ILi25ELb0E", "ILi59ELb1E", "sketch_sm90_kernelILi24ELb1E", "sketch_sm90_kernelILi0ELb0E",
                    "assign_kernelILi8E", "seg_sort_kernelILi8ELi2E", "sweep_hist_kernel", "sweep_plan_kernel",
                    "sweep_pass_kernel", "brick_spmm_kernelILi1E", "brick_spmm_kernelILi4E", "brick_sddmm_kernel",
                    "sddmm_sm90_kernel",
                    "attn_f32_kernelILi4ELi64E", "attn_bf16_kernelILi256E", "attn_sm90_kernelILi64ELi3E",
                    "attn_sm90_kernelILi128ELi2E", "attn_sm90_kernelILi256ELi2E", "attn_sm90_f32_kernelILi2E",
                    "11pack_kernelIjjE", "13unpack_kernelIjjE", "threefry_kernelILi2EfLb1E",
                    "threefry_kernelILi2EfLb0E", "threefry_kernelILi2E13__nv_bfloat16Lb1E",
                    "threefry_kernelILi3EiLb1E")
            if "serializ" in line.lower():
                print(f"ptxas {name}: {line.strip()}", flush=True)
            tags = [tag for tag in main if tag in line]
            if "Compiling entry function" in line and tags:
                detail = " | ".join(s.split(":", 1)[-1].strip() for s in lines[i + 1 : i + 4])
                print(f"ptxas {line.split(chr(39))[1][:48]} ({tags[0]}): {detail}", flush=True)
            # K1's Hopper kernel (every instantiation) must not spill
            if "Compiling entry function" in line and any(t in line for t in NO_SPILLS):
                spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", " ".join(lines[i + 1 : i + 4]))
                _require(len(spills) == 2 and spills == ["0", "0"], f"ptxas spills in {line.split(chr(39))[1]}")


def _k2_case(cs, a, gen, l: int = 59, k: int = 24) -> dict:
    """K2 on ``a`` against its plain version, on the kernel its predicate
    picks (its Hopper launch count must show which), and against itself on
    a rerun; on the Hopper kernel sketch.cu's kernel runs on the same inputs
    too, held to the plain version under the same limits. Returns the main
    shape's largest errors (empty elsewhere)."""
    import torch

    m, n = a.shape
    g = torch.randn(l, m, device=a.device, generator=gen)
    omega = torch.randn(n, k, device=a.device, generator=gen)
    hopper = cs.dual_sketch_sm90_serviceable(l, k, a)
    before = cs.DUAL_SM90_LAUNCHES
    w, y, norm = cs.dual_sketch_with_norm(g, omega, a)
    pw, py, pnorm = cs.dual_sketch_with_norm_plain(g, omega, a)
    torch.cuda.synchronize()
    _require(cs.DUAL_SM90_LAUNCHES == before + int(hopper),
             f"K2 ({m}x{n}) {'did not take' if hopper else 'took'} the Hopper kernel")
    ew, ey, en = _rel(w, pw), _rel(y, py), abs(float(norm) - float(pnorm)) / float(pnorm)
    rerun = all(map(torch.equal, (w, y, norm), cs.dual_sketch_with_norm(g, omega, a)))
    route, old = "sketch_sm90" if hopper else "sketch", ""
    ok_old = True
    if hopper:
        ow, oy, onorm = cs._dual_sketch_with_norm_sketch_cu(g, omega, a)
        torch.cuda.synchronize()
        eow, eoy, eon = _rel(ow, pw), _rel(oy, py), abs(float(onorm) - float(pnorm)) / float(pnorm)
        ok_old = eow <= TOL_W and eoy <= TOL_W and eon <= TOL_NORM
        old = f"; sketch.cu's kernel: w rel {eow:.3e}, y rel {eoy:.3e}, norm rel {eon:.3e}"
    print(
        f"K2 {route} ({m}x{n}, l={l}, k={k}): w rel {ew:.3e}, y rel {ey:.3e} (tol {TOL_W}), "
        f"norm rel {en:.3e} (tol {TOL_NORM}), rerun identical {rerun}{old}", flush=True,
    )
    _require(ew <= TOL_W and ey <= TOL_W and en <= TOL_NORM and rerun and ok_old,
             f"K2 disagrees with its plain version or itself at {m}x{n}, l={l}, k={k}")
    if (m, n, l, k) != (M, N, 59, 24):
        return {}
    errs = {"dual_sketch_with_norm": max(float((w - pw).abs().max()), float((y - py).abs().max()))}
    if hopper:
        errs["dual_sketch_with_norm_pr1"] = max(float((ow - pw).abs().max()), float((oy - py).abs().max()))
    return errs


def _k1_case(cs, a, gen, l: int) -> dict:
    """K1 on ``a`` against its plain version, on the kernel its predicate
    picks (its Hopper launch count must show which), and against itself on
    a rerun; on the Hopper kernel sketch.cu's kernel runs on the same inputs
    too, held to the plain version under the same limits. Returns the main
    shape's largest errors (empty elsewhere)."""
    import torch

    m, n = a.shape
    g = torch.randn(l, m, device=a.device, generator=gen)
    hopper = cs.sketch_sm90_serviceable(l, a)
    before = cs.SKETCH_SM90_LAUNCHES
    w, norm = cs.sketch_with_norm(g, a)
    pw, pnorm = cs.sketch_with_norm_plain(g, a)
    torch.cuda.synchronize()
    _require(cs.SKETCH_SM90_LAUNCHES == before + int(hopper),
             f"K1 ({m}x{n}) {'did not take' if hopper else 'took'} the Hopper kernel")
    ew, en = _rel(w, pw), abs(float(norm) - float(pnorm)) / float(pnorm)
    # partials are summed in a fixed order: a rerun gives the same bits
    rerun = all(map(torch.equal, (w, norm), cs.sketch_with_norm(g, a)))
    route, old, ok_old = "sketch_sm90" if hopper else "sketch", "", True
    if hopper:
        ow, onorm = cs._sketch_with_norm_sketch_cu(g, a)
        torch.cuda.synchronize()
        eow, eon = _rel(ow, pw), abs(float(onorm) - float(pnorm)) / float(pnorm)
        ok_old = eow <= TOL_W and eon <= TOL_NORM
        old = f"; sketch.cu's kernel: w rel {eow:.3e}, norm rel {eon:.3e}"
    print(f"K1 {route} ({m}x{n}, l={l}): w rel {ew:.3e} (tol {TOL_W}), norm rel {en:.3e} (tol {TOL_NORM}), "
          f"rerun identical {rerun}{old}", flush=True)
    _require(ew <= TOL_W and en <= TOL_NORM and rerun and ok_old,
             f"K1 disagrees with its plain version or itself at {m}x{n}, l={l}")
    if (m, n, l) != (M, N, 25):
        return {}
    errs = {"sketch_with_norm": float((w - pw).abs().max())}
    if hopper:
        errs["sketch_with_norm_pr1"] = float((ow - pw).abs().max())
    return errs


def check_kernels(dev) -> dict:
    """Each kernel against its plain version; returns the main-shape errors."""
    import torch

    from heat_tpu_torch.core.linalg import _cuda_sketch as cs

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    errs = {}
    for m, n in (RAGGED, (M, N)):
        a = torch.randn(m, n, device=dev, generator=gen)
        for l in (7, 25):
            errs.update(_k1_case(cs, a, gen, l))
        errs.update(_k2_case(cs, a, gen))
        del a
    # a ragged shape the Hopper kernels serve (n % 4 == 0), and the widest
    # row and column sketches they take
    a = torch.randn(*K2_RAGGED_SM90, device=dev, generator=gen)
    _k2_case(cs, a, gen)
    _k2_case(cs, a, gen, l=64, k=32)
    _k2_case(cs, a * 1e3, gen, l=1, k=1)
    for l in (1, 25, 32):
        _k1_case(cs, a, gen, l)
    _k1_case(cs, a * 1e-3, gen, 32)
    _k1_case(cs, torch.randn(130, 8, device=dev, generator=gen), gen, 7)
    del a
    # the world phase's level-0 shapes that differ from the main path's: a
    # split-1 shard's pass 1 (g 25 x 8192 over a 8192 x 65536 column block)
    # and the one-view on a split-0 shard's copied Sᵀ (the same shape)
    a = torch.randn(N, M, device=dev, generator=gen)
    _k1_case(cs, a, gen, 25)
    _k2_case(cs, a, gen)
    del a
    errs.update(check_quant(dev))
    return errs


def _blobs(gen, n: int, means):
    """Blobs of n // k rows each around the k ``means`` (n divisible by k),
    with unit-variance Gaussian noise, built on the card."""
    import torch

    x = torch.randn(n, means.shape[1], device=means.device, generator=gen)
    x += means.repeat_interleave(n // means.shape[0], dim=0)
    return x


def _axis_means(dev, d: int, k: int, scale: float = 8.0):
    """k ≤ 2d means ±scale·e_j: every pair at least scale·√2 apart, 5.7
    noise deviations from their bisector, at a magnitude that keeps the
    float32 quadratic expansion from cancelling."""
    import torch

    idx = torch.arange(k, device=dev)
    means = torch.zeros(k, d, device=dev)
    means[idx, idx % d] = scale * (1.0 - 2.0 * (idx >= d).float())
    return means


def check_assign(dev) -> float:
    """K3 against its plain version on Gaussian data (centers drawn from
    X) and on well-separated blobs; returns the largest absolute error of
    the sums at the main shape."""
    import torch

    from heat_tpu_torch.cluster import _cuda_assign as ca

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    main_err = None
    for n, d, k in K3_SHAPES:
        n_blob = n - n % k
        for data in ("gaussian", "blobs"):
            if data == "gaussian":
                x = torch.randn(n, d, device=dev, generator=gen)
                c = x[torch.randperm(n, device=dev, generator=gen)[:k]].contiguous()
            else:
                c = _axis_means(dev, d, k)
                x = _blobs(gen, n_blob, c)
            sums, counts, inertia = ca.fused_assign(x, c)
            psums, pcounts, pinertia = ca.fused_assign_plain(x, c)
            torch.cuda.synchronize()
            es = _rel(sums, psums)
            ei = abs(float(inertia) - float(pinertia)) / float(pinertia)
            flips = float((counts - pcounts).abs().sum())
            limit = TOL_FLIPS * x.shape[0] if data == "gaussian" else 0.0
            print(
                f"K3 ({x.shape[0]}x{d}, k={k}, {data}): sums rel {es:.3e} (tol {TOL_SUMS}), inertia rel "
                f"{ei:.3e} (tol {TOL_INERTIA}), sum |count diff| {flips:.0f} (limit {limit:.0f})", flush=True,
            )
            _require(es <= TOL_SUMS and ei <= TOL_INERTIA and flips <= limit,
                     f"K3 disagrees with its plain version at {x.shape[0]}x{d}, k={k} ({data})")
            _require(all(map(torch.equal, (sums, counts, inertia), ca.fused_assign(x, c))), "K3 is not repeatable")
            if (n, d, k, data) == (KM_N, KM_D, KM_K, "gaussian"):
                main_err = float((sums - psums).abs().max())
            del x
    return main_err


def _random_words(gen, n: int, dev, high: int = None):
    """n random u32 words (int32 bit patterns), or values in [0, high)."""
    import torch

    if high is None:
        return torch.randint(-(2**31), 2**31, (n,), device=dev, generator=gen, dtype=torch.int32)
    return torch.randint(0, high, (n,), device=dev, generator=gen, dtype=torch.int32)


def _unsigned(words):
    return words.long() & 0xFFFFFFFF


def _adversarial_f32(kind: str, gen, dev):
    """float32 keys of the kinds of tests/test_kernels_sort.py, and one of
    special values: ±0, ±inf, ±max, NaNs of both signs, subnormals."""
    import torch

    x = torch.randn(ADV_N, device=dev, generator=gen)
    if kind == "sorted":
        x = torch.sort(x).values
    elif kind == "reverse":
        x = torch.sort(x, descending=True).values
    elif kind == "const":
        x = torch.full_like(x, float(x[0]))
    elif kind == "fewuniq":
        x = x[torch.randint(0, 7, (ADV_N,), device=dev, generator=gen)]
    elif kind == "nan":
        x[torch.rand(ADV_N, device=dev, generator=gen) < 0.15] = float("nan")
    elif kind == "specials":
        bits = torch.tensor(
            [0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7F7FFFFF, 0xFF7FFFFF, 0x7FC00000,
             0xFFC00000, 0x7FFFFFFF, 0xFFFFFFFF, 0x00000001, 0x807FFFFF, 0x3F800000],
            device=dev, dtype=torch.int64,
        )
        pick = bits[torch.randint(0, len(bits), (ADV_N,), device=dev, generator=gen)]
        x = torch.where(pick >= 2**31, pick - 2**32, pick).to(torch.int32).view(torch.float32)
    return x


def _k4_case(ks, label: str, keys, pays=None, seg_len=None, pay_bytes=0) -> int:
    """K4 against its plain version and against itself on a rerun, exactly;
    where the payload is the position, the payloads must also be torch's
    stable argsort of the keys. Returns the largest absolute difference."""
    import torch

    got = ks.pair_sort(keys, pays, seg_len, pay_bytes)
    ref = ks.pair_sort_plain(keys, pays, seg_len, pay_bytes)
    again = ks.pair_sort(keys, pays, seg_len, pay_bytes)
    torch.cuda.synchronize()
    err = max(int((g.long() - r.long()).abs().max()) for g, r in zip(got, ref))
    rerun = all(map(torch.equal, got, again))
    argsort = "n/a"
    if pays is None:
        rows = keys.numel() // (seg_len or keys.numel())
        expect = torch.sort(_unsigned(keys).reshape(rows, -1), dim=1, stable=True).indices
        argsort = torch.equal(got[1].long().reshape(rows, -1), expect)
        _require(argsort, f"K4 ({label}) is not torch's stable argsort")
    print(
        f"K4 ({label}): max |difference| from the plain version {err} (tol 0), rerun identical {rerun}, "
        f"payload equals torch's stable argsort {argsort}", flush=True,
    )
    _require(err == 0 and rerun, f"K4 disagrees with its plain version or itself ({label})")
    return err


# K4's fused entry in each transform mode, order and output: (total, descending, out)
K4_FUSED_MODES = ((False, False, "values"), (False, True, "values"), (False, False, "words"),
                  (True, True, None), (True, True, "values"), (True, False, "values"))


def _bits_of(t):
    import torch

    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _fused_case(ks, label: str, x, seg_len=None, modes=K4_FUSED_MODES) -> int:
    """K4's fused entry against its plain composition (sort_key,
    pair_sort_plain, from_sortable) bit for bit, and against itself on a
    rerun, in each (total, descending, out) of ``modes``. Returns the
    largest absolute difference of the raw bits."""
    import torch

    err, rerun = 0, True
    for total, descending, out in modes:
        got = ks.fused_sort(x, seg_len, total=total, descending=descending, out=out)
        ref = ks.fused_sort_plain(x, seg_len, total=total, descending=descending, out=out)
        again = ks.fused_sort(x, seg_len, total=total, descending=descending, out=out)
        torch.cuda.synchronize()
        for g, r, a in zip(got, ref, again):
            _require((g is None) == (r is None) and (g is None or g.dtype == r.dtype), f"K4 fused ({label}) types")
            if g is not None:
                err = max(err, int((_bits_of(g).long() - _bits_of(r).long()).abs().max()))
                rerun = rerun and torch.equal(_bits_of(g), _bits_of(a))
    print(f"K4 fused ({label}, {len(modes)} transform/order/output modes): max |difference| of the bits from "
          f"the plain composition {err} (tol 0), rerun identical {rerun}", flush=True)
    _require(err == 0 and rerun, f"K4's fused entry disagrees with its plain composition or itself ({label})")
    return err


def _k4_huge_case(ks, gen, dev, n: int) -> None:
    """One segment of n pairs, too large for the plain version: the result
    must be a stable sort, which the invariants below pin exactly (keys
    non-decreasing, payloads a permutation, keys equal to the input at the
    payloads, payloads increasing within each run of equal keys), and a
    rerun must give the same bits."""
    import torch

    keys = _random_words(gen, n, dev)
    t0 = time.perf_counter()
    out_k, out_p = ks.pair_sort(keys)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    seen = torch.zeros(n, dtype=torch.bool, device=dev)
    step = 1 << 26
    ok = True
    for s in range(0, n, step):
        e = min(n, s + step + 1)
        k, p = _unsigned(out_k[s:e]), out_p[s:e].long()
        ok &= bool((k[1:] >= k[:-1]).all())
        ties = k[1:] == k[:-1]
        ok &= bool((p[1:][ties] > p[:-1][ties]).all())
        ok &= torch.equal(keys[p[: step]], out_k[s : s + step])
        seen[p[: step]] = True
        del k, p, ties
    ok &= bool(seen.all())
    del seen
    again_k, again_p = ks.pair_sort(keys)
    rerun = torch.equal(out_k, again_k) and torch.equal(out_p, again_p)
    print(f"K4 (n={n}, one segment, {-(-n // 4096)} tiles in the look-back): a stable sort of the keys {ok}, "
          f"rerun identical {rerun} (first call {ms:.1f} ms by the host clock)", flush=True)
    _require(ok and rerun, f"K4 at n={n} is not the stable sort of its keys, or a rerun differs")


def check_sort(dev) -> dict:
    """K4 against its plain version at the listed shapes; returns the
    largest error of each regime's main shape."""
    import torch

    from heat_tpu_torch.kernels import sort as ks

    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    errs = {}
    keys = _random_words(gen, SORT_N, dev)
    errs["pair_sort_one_segment"] = max(_k4_case(ks, f"n={SORT_N}, one segment", keys),
                                        _fused_case(ks, f"n={SORT_N} float32 randn, one segment",
                                                    torch.randn(SORT_N, device=dev, generator=gen)))
    del keys
    keys, pays = _random_words(gen, SORT_N, dev, 1000), _random_words(gen, SORT_N, dev)
    _k4_case(ks, f"n={SORT_N}, 1000 key values, pay_bytes=4", keys, pays, pay_bytes=4)
    del keys, pays
    keys = _random_words(gen, SORT_ROWS * SORT_SEG, dev)
    errs["pair_sort_segments"] = max(
        _k4_case(ks, f"{SORT_ROWS} segments of {SORT_SEG}", keys, seg_len=SORT_SEG),
        _fused_case(ks, f"{SORT_ROWS} float32 randn segments of {SORT_SEG}",
                    torch.randn(SORT_ROWS * SORT_SEG, device=dev, generator=gen), SORT_SEG))
    del keys
    for rows, seg in ((10_007, 777), (2048, ks.SEG_MAX), (1, ks.SEG_MAX + 1), (1, 1), (100_003, 100),
                      (1, 2 * 4096 - 1), (1, 2 * 4096), (1, 2 * 4096 + 1), (1, 3_000_017)):
        words = _random_words(gen, rows * seg, dev, 3000)
        _k4_case(ks, f"{rows} segment(s) of {seg}", words, seg_len=seg)
        _fused_case(ks, f"{rows} segment(s) of {seg}, the words as float32", words.view(torch.float32), seg)
    for kind in ("sorted", "reverse", "const", "fewuniq", "nan", "specials"):
        x = _adversarial_f32(kind, gen, dev)
        u = ks.to_sortable(x)
        _k4_case(ks, f"{kind} float32 keys, one segment of {ADV_N}", u)
        _k4_case(ks, f"{kind} float32 keys, segments of {SORT_SEG}", u, seg_len=SORT_SEG)
        _fused_case(ks, f"{kind} float32, one segment of {ADV_N}", x)
        _fused_case(ks, f"{kind} float32, segments of {SORT_SEG}", x, SORT_SEG)
    ints = _random_words(gen, ADV_N, dev)
    ends = torch.tensor([-(2**31), -(2**31) + 1, -1, 0, 1, 2**31 - 2, 2**31 - 1], device=dev, dtype=torch.int32)
    pick = torch.rand(ADV_N, device=dev, generator=gen) < 0.5
    ints[pick] = ends[torch.randint(0, len(ends), (int(pick.sum()),), device=dev, generator=gen)]
    _fused_case(ks, f"int32 with its extremes, one segment of {ADV_N}", ints)
    _fused_case(ks, f"int32 with its extremes, segments of {SORT_SEG}", ints, SORT_SEG)
    # constant digit places, whose passes the one-sweep regime skips
    n = ADV_N + 3
    top = torch.randint(0, 256, (n,), device=dev, generator=gen, dtype=torch.int32)
    for label, words in (
        ("all-equal keys (every place constant)", torch.full((n,), 0x3F800000, device=dev, dtype=torch.int32)),
        ("keys that differ only in the top byte", (top << 24) | 0x123456),
        ("randint(0, 1000) (the top two bytes constant)", _random_words(gen, n, dev, 1000)),
    ):
        _k4_case(ks, f"{label}, one segment of {n}", words)
        _fused_case(ks, f"{label} as float32, one segment of {n}", words.view(torch.float32))
        _fused_case(ks, f"{label} as int32, one segment of {n}", words)
    del x, u, ints, top, words
    # the local steps of the distributed sort networks (core.parallel): keys with heavy ties and NaN, the
    # global indices as payload ordered by their low 2 or 4 bytes; one segment of B (a columnsort step of
    # sort_1gb over WORLD ranks), of 2(B + 1) (an odd-even merge of sort_1gb_ragged), and 2B segments
    block = SORT_N // WORLD
    for n, seg, label in ((block, None, "a columnsort step"), (2 * (block + 1), None, "an odd-even merge"),
                          (1000 * 2 * 1500, 2 * 1500, "batch lanes of 2B = 3000")):
        ties = torch.randint(-50, 50, (n,), device=dev, generator=gen).float()
        ties[torch.rand(n, device=dev, generator=gen) < 0.1] = float("nan")
        pos = torch.randperm(n, device=dev, generator=gen).to(torch.int32)
        for pay_bytes in (2, 4):
            pays = pos & 0xFFFF if pay_bytes == 2 else pos
            errs["pair_sort_one_segment"] = max(errs["pair_sort_one_segment"], _k4_case(
                ks, f"{label}: {n} pairs, heavy ties and NaN keys, index payload, pay_bytes={pay_bytes}",
                ks.sort_key(ties), pays, seg, pay_bytes))
        del ties, pos, pays
    _k4_huge_case(ks, gen, dev, 1 << 30)
    return errs


# --------------------------------------------------------------------- #
# the random stream (kernel R1)                                         #
# --------------------------------------------------------------------- #
def _r1_zero():
    from heat_tpu_torch.kernels import threefry as kt

    kt.THREEFRY_LAUNCHES = 0
    kt.THREEFRY_ELEMENTS.clear()


def _r1_read(label: str, launches: int, elements: list = None) -> dict:
    """R1's launches since ``_r1_zero``, which must be ``launches`` (one a
    draw), and their element counts, which must be ``elements`` where
    given; kept in ``R1_PATH[label]``."""
    from heat_tpu_torch.kernels import threefry as kt

    got = {"launches": kt.THREEFRY_LAUNCHES, "elements": list(kt.THREEFRY_ELEMENTS)}
    print(f"{label}: R1 launches {got['launches']}, elements {got['elements']}", flush=True)
    _require(got["launches"] == launches and (elements is None or got["elements"] == elements),
             f"{label}: R1 launched {got}, not {launches} time(s) of {elements} elements")
    R1_PATH[label] = got
    return got


def _r1_chunk_index(chunk, lo: int, hi: int, device):
    """The global flat indices of a chunk's local elements [lo, hi) (row
    major): start * inner + e + (e // row) * (extent - length) * inner."""
    import torch

    _, ext, start, length, inner = chunk.geometry()
    e = torch.arange(lo, hi, device=device, dtype=torch.int64)
    return start * inner + e + torch.div(e, length * inner, rounding_mode="floor") * ((ext - length) * inner)


def _r1_sample_err(kt, out, mode: str, key, chunk, dtype, args, label: str) -> float:
    """R1's draw ``out`` of ``chunk`` against its plain version at the
    first and last R1_SAMPLE local elements and, where a contiguous chunk's
    flat indices cross 2^32, the R1_SAMPLE around the crossing; bits,
    uniforms and integers must be equal, normals too (0 ulp). Returns the
    largest |difference| (0)."""
    import torch

    outer, _, start, _, inner = chunk.geometry()
    base, n = start * inner, chunk.numel
    flat = out.reshape(-1)
    spans = [(0, min(n, R1_SAMPLE)), (max(0, n - R1_SAMPLE), n)]
    if outer == 1 and base < 2**32 < base + n:
        mid = 2**32 - base
        spans.append((max(0, mid - R1_SAMPLE // 2), min(n, mid + R1_SAMPLE // 2)))
    err = 0.0
    for lo, hi in spans:
        idx = _r1_chunk_index(chunk, lo, hi, out.device)
        want = kt.plain_at(mode, key, idx, dtype, args)
        got = flat[lo:hi]
        word = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[got.element_size()]
        same = torch.equal(got.view(word), want.view(word))
        err = max(err, float((got.double() - want.double()).abs().max()))
        _require(same, f"{label}: R1 differs from its plain version at local elements [{lo}, {hi})")
    crosses = len(spans) == 3
    print(f"{label}: R1 equal to its plain version bit for bit at {len(spans)} spans of {R1_SAMPLE} elements"
          f"{' (one across flat index 2^32)' if crosses else ''}{'' if outer == 1 else f' ({outer} rows)'}",
          flush=True)
    return err


def _stream_key(seed: int, counter: int):
    """The key of the global stream's draw at (seed, counter), as
    ``ht.random`` takes it (``_next_key``)."""
    from heat_tpu_torch.core import _threefry as tf

    return tf.fold_in(tf.fold_in(tf.seed_key(seed), counter & 0xFFFFFFFF), counter >> 32)


def _mha_bounds():
    """MultiheadAttention's uniform bounds of in_proj and out_proj."""
    return math.sqrt(6.0 / (4 * MHA_E)), 1.0 / math.sqrt(MHA_E)


def _r1_draws():
    """The main paths' draws at full size: (label, mode, key, chunk, dtype,
    args): the north star's A and sort_1gb's keys as the paths draw them
    after ``seed(0)``; rank 1's chunk of the north star drawn split 1 over
    WORLD ranks (outer > 1: 65536 rows of 2048, as the world draws it);
    the KMeans shard as chip 4's chunk of BASELINE's
    1B x 64 draw, whose flat indices cross 2^32; the attention path's
    bfloat16 RAB q after ``seed(5)`` and the RA draws; and
    MultiheadAttention(1024)'s bfloat16 in_proj from ``seed_key(23)``."""
    import torch

    from heat_tpu_torch.core import _threefry as tf

    km = tf.Chunk((KM_GLOBAL_ROWS, KM_D), 0, KM_CHIP * KM_N, KM_N)
    bound = _mha_bounds()[0]
    return [
        ("r1_normal_north_star", "normal", _stream_key(0, 0), tf.Chunk.whole((M, N)), torch.float32, (0.0, 1.0)),
        ("r1_normal_north_star_split1", "normal", _stream_key(0, 0), tf.Chunk((M, N), 1, N // WORLD, N // WORLD),
         torch.float32, (0.0, 1.0)),
        ("r1_normal_kmeans_chip4", "normal", _stream_key(0, 0), km, torch.float32, (0.0, 1.0)),
        ("r1_randint_sort_1gb", "randint", _stream_key(1, 0), tf.Chunk.whole((SORT_N,)), torch.int32, (0, 1000)),
        ("r1_normal_bf16_rab", "normal", _stream_key(5, 6 * math.prod(RA)), tf.Chunk.whole(RAB), torch.bfloat16,
         (0.0, 1.0)),
        ("r1_uniform_bf16_mha_in_proj", "uniform", tf.split(tf.seed_key(MHA_SEED))[0],
         tf.Chunk.whole((MHA_E, 3 * MHA_E)), torch.bfloat16, (-bound, bound)),
    ]


def check_random(dev) -> dict:
    """R1 against its plain version on the card at the main paths' full
    sizes (sampled: see ``_r1_sample_err``), one launch each; returns the
    largest |difference| of each."""
    import torch

    from heat_tpu_torch.kernels import threefry as kt

    errs = {}
    for label, mode, key, chunk, dtype, args in _r1_draws():
        before = kt.THREEFRY_LAUNCHES
        out = kt.draw(mode, key, chunk, dtype, dev, args)
        torch.cuda.synchronize()
        _require(kt.THREEFRY_LAUNCHES == before + 1 and tuple(out.shape) == chunk.lshape, f"{label}: one launch")
        errs[label] = _r1_sample_err(kt, out, mode, key, chunk, dtype, args, label)
        del out
    torch.cuda.empty_cache()
    check_normal_transform(dev)
    return errs


def normal_transform_domain(dtype, device):
    """One int32 word for each uniform a normal draw of ``dtype`` can make:
    every value of the random bits its ``_uniform`` reads (float32's top 23
    bits of b1 ^ b2, float16's bits 6..15, bfloat16's bits 1..7)."""
    import torch

    shift, width = {torch.float32: (9, 23), torch.float16: (6, 10), torch.bfloat16: (1, 7)}[dtype]
    words = torch.arange(1 << width, dtype=torch.int64, device=device) << shift
    return (words - ((words >> 31) << 32)).to(torch.int32)


def check_normal_transform(dev) -> None:
    """R1's normal transform (its float32 log1p and square root written out,
    the 16-bit roundings) against its plain version on the card, bit for
    bit, on every input a float32, float16 or bfloat16 draw can give it,
    plain and scaled by std and mean."""
    import torch

    from heat_tpu_torch.core import _threefry as tf
    from heat_tpu_torch.kernels import threefry as kt

    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        words = normal_transform_domain(dtype, dev)
        bits = words.long() & ((1 << tf.uniform_bits(dtype)) - 1)
        for args in ((0.0, 1.0), (3.0, 0.5)):
            got = kt.normal_of_words(words, dtype, args)
            want = tf.normal_of_bits(bits, dtype, *args)
            word = torch.int32 if dtype == torch.float32 else torch.int16
            differ = int((got.view(word) != want.view(word)).sum())
            print(f"R1 normal transform, {str(dtype)[6:]}, mean and std {args}: {words.numel()} inputs, "
                  f"{differ} differ from the plain version", flush=True)
            _require(differ == 0, f"R1's normal transform differs from its plain version on {differ} inputs "
                     f"({dtype}, {args})")


# Per-SM throughput of compute capability 9.0, results a clock (the CUDA C++
# Programming Guide's table "Throughput of Native Arithmetic Instructions"):
# 32-bit integer add, shift, compare, minimum, maximum and bitwise operations
# 64 (the integer pipe, "alu"); float32 add, multiply and multiply-add 128
# (the FMA pipe, "fma"); 32-bit integer multiply and multiply-add 64, on the
# FMA pipe's heavy half (so the pipe takes max(imad / 64, (imad + fp32) /
# 128) clocks); reciprocal square root and every conversion but the integer
# widenings 16 ("xu"). Every operation also takes an issue slot: one warp
# instruction a clock on each of an SM's 4 schedulers ("issue", 128 lanes).
R1_RATES = {"alu": 64, "fma": 128, "imad": 64, "xu": 16, "issue": 128}
SM_COUNT = 132

# The operations one element of a draw needs, by class, counted from the
# function and not from any kernel's code. A Threefry-2x32 block (20 rounds):
# 20 rotations (funnel shifts) and 20 xors on the integer pipe; 31 adds (the
# 20 rounds', the 10 injected key words and the counter's, x1 = lo + k1; x0 =
# hi + k0 is shared by every element of one high word), each an IADD3 on the
# integer pipe or an IMAD on the FMA pipe, and 4 x0 injections that may
# merge with the next round's add into one three-input IADD3. The
# transforms, per element:
# - bits of 32: the xor of the block's two words (int 1);
# - uniform: the float from the xor (one three-input op and one shift-and-or,
#   int 2), minus 1 (fp32 1), times the span plus the minimum (float32: one
#   FMA; float16 and bfloat16: a float32 multiply and add, fp32 2), the clamp
#   to the minimum (int 1); bfloat16 rounds the product to the dtype and
#   unpacks it (xu 1/2, a packed conversion of two elements, int 1), and a
#   16-bit draw's last rounding is its output's conversion (xu 1/2);
# - normal: that uniform on (nextafter(-1, 0), 1), then float32's erf_inv:
#   x * -x (fp32 1); log1p as the CUDA math library computes it, which torch's
#   log1p calls (fp32 15, int 4, xu 1: the exponent's conversion); the range
#   test and the select of w or sqrt(w) (int 2); the square root (xu 1, fp32
#   4); the offset (fp32 1); the 9-term Horner chain, unfused as XLA's (fp32
#   16); the |x| = 1 test and select (int 2); p * x (fp32 1); then times
#   sqrt(2) (fp32 1). A 16-bit draw unpacks its uniform (int 1), rounds
#   erf_inv's result to the dtype and unpacks it (xu 1/2, int 1) and rounds
#   its output (xu 1/2). The choice of a range's coefficients is left out (a
#   table read or a select each: more than none), and so are std and mean,
#   so that the count stays a lower bound;
# - randint (sampled in 32 bits): two blocks (two subkeys), the two xors (int
#   2), three remainders by the span, each at least a reciprocal's high
#   multiply, a shift and a multiply-subtract (imad 2, int 1), the multiply-add
#   of the two remainders (imad 1) and the minimum's add (add 1).
R1_BLOCK = {"int": 40, "add": 31, "fold": 4}


def _r1_sum(*parts) -> dict:
    return {k: sum(p.get(k, 0) for p in parts) for k in {k for p in parts for k in p}}


_R1_UNIFORM = {"float32": {"int": 3, "fp32": 2}, "bfloat16": {"int": 4, "fp32": 3, "xu": 1},
               "float16": {"int": 3, "fp32": 3, "xu": 0.5}}
_R1_NORMAL = {"int": 8, "fp32": 38 + 1, "xu": 2}  # erf_inv, times sqrt(2)
_R1_HALF_NORMAL = {"int": 2, "xu": 1}
R1_OPERATIONS = {
    ("bits", "int32"): {"blocks": 1, "int": 1},
    **{("uniform", dt): _r1_sum({"blocks": 1}, u) for dt, u in _R1_UNIFORM.items()},
    **{("normal", dt): _r1_sum({"blocks": 1}, u, _R1_NORMAL, _R1_HALF_NORMAL if dt != "float32" else {})
       for dt, u in _R1_UNIFORM.items()},
    ("randint", "int32"): {"blocks": 2, "int": 5, "imad": 7, "add": 1},
}


def r1_clocks(mode: str, dtype) -> dict:
    """The SM clocks an element of a draw takes at the least, from
    ``R1_OPERATIONS``: each pipe's and the issue slots' clocks with the adds
    placed between the integer and FMA pipes, and the merges made, where
    the busiest of them is least; ``pipe`` names that busiest one. Types of
    64 bits are not in the table."""
    ops = R1_OPERATIONS[(mode, str(dtype).replace("torch.", ""))]
    b = ops["blocks"]
    fp32, imad, xu = ops.get("fp32", 0), ops.get("imad", 0), ops.get("xu", 0)
    best = None
    for merged in range(b * R1_BLOCK["fold"] + 1):
        alu = b * R1_BLOCK["int"] + ops.get("int", 0) + merged
        adds = b * R1_BLOCK["add"] + ops.get("add", 0) - 2 * merged
        # the integer pipe's clocks grow with the adds it takes, the FMA
        # pipe's fall: the best split is where they meet, within [0, adds]
        on_alu = min(max((imad + adds - alu) / 2, (imad + adds + fp32 - 2 * alu) / 3, 0.0), adds)
        clocks = {
            "alu": (alu + on_alu) / R1_RATES["alu"],
            "fma": max((imad + adds - on_alu) / R1_RATES["imad"], (imad + adds - on_alu + fp32) / R1_RATES["fma"]),
            "xu": xu / R1_RATES["xu"],
            "issue": (alu + adds + imad + fp32 + xu) / R1_RATES["issue"],
        }
        pipe = max(clocks, key=clocks.get)
        if best is None or clocks[pipe] < best["clocks"][best["pipe"]]:
            best = {"clocks": clocks, "pipe": pipe, "merged": merged, "adds_on_alu": on_alu,
                    "operations": alu + adds + imad + fp32 + xu}
    return best


def _sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def r1_bound(mode: str, chunk, dtype, clock: float):
    """(bound ms, "bytes" or "operations", the pipe or "hbm" that sets it,
    bytes ms, operations ms, ``r1_clocks``) of one R1 draw: the output
    written once over 3.35 TB/s against the function's operations
    (``r1_clocks``) on 132 SMs at ``clock``."""
    import torch

    n = chunk.numel
    count = r1_clocks(mode, dtype)
    t_bytes = float(n) * torch.empty((), dtype=dtype).element_size() / HBM_BYTES_PER_S * 1e3
    t_ops = n * count["clocks"][count["pipe"]] / (SM_COUNT * clock) * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", "hbm", t_bytes, t_ops, count
    return t_ops, "operations", count["pipe"], t_bytes, t_ops, count


def random_timings(dev, errs: dict) -> list:
    """R1's rows: its time at each main-path draw (CUDA-event median of a
    lone call, and device time of queued calls, ``_device_ms``), the plain
    version's (the draw in pieces of 2^25 elements, one after the other, so
    that its int64 temporaries fit), torch's own generator on the same
    shape as context only (another stream: no library call computes
    heat_tpu's), and the bound: the larger of the output written once over
    3.35 TB/s and the function's operations on the busiest pipe or issue
    slots (``r1_bound``, at the maximum SM clock)."""
    import torch

    from heat_tpu_torch.kernels import threefry as kt

    clock = _sm_clock_hz()
    # the main-path calls whose R1 launches each row reports
    main = {"r1_normal_north_star": ("hsvd_draw", "hsvd_2pass", "hsvd_one_view", "ring_attention_ra_f32_draw"),
            "r1_normal_north_star_split1": (),
            "r1_normal_kmeans_chip4": ("kmeans_draw", "kmeans_fit"),
            "r1_randint_sort_1gb": ("sort_draw", "sort_ints_draw", "sort_rows_draw"),
            "r1_normal_bf16_rab": ("ring_attention_ra_bf16_draw", "ring_attention_rab_bf16_draw"),
            "r1_uniform_bf16_mha_in_proj": ("mha_1024_init",)}
    rows = []
    for label, mode, key, chunk, dtype, args in _r1_draws():
        n = chunk.numel
        call = lambda: kt.draw(mode, key, chunk, dtype, dev, args)  # noqa: E731
        ms = _median_ms(call, 10)
        device_ms = _device_ms(call, 10)
        piece = 1 << 25

        def plain():
            for lo in range(0, n, piece):
                kt.plain_at(mode, key, _r1_chunk_index(chunk, lo, min(n, lo + piece), dev), dtype, args)

        plain_ms = _median_ms(plain, 3)
        if mode == "randint":
            context = lambda: torch.randint(*args, chunk.lshape, device=dev, dtype=dtype)  # noqa: E731
        elif mode == "normal":
            context = lambda: torch.randn(chunk.lshape, device=dev, dtype=dtype)  # noqa: E731
        else:
            context = lambda: torch.rand(chunk.lshape, device=dev, dtype=dtype)  # noqa: E731
        torch_ms = _median_ms(context, 10)
        bound_ms, bound_by, pipe, t_bytes, t_ops, count = r1_bound(mode, chunk, dtype, clock)
        path = {call: R1_PATH[call]["launches"] for call in main[label]}
        print(
            f"{label}: {mode} {tuple(chunk.lshape)} {str(dtype)[6:]}: R1 {ms:.4f} ms (device {device_ms:.4f} ms), "
            f"plain {plain_ms:.4f} ms, torch's own generator {torch_ms:.4f} ms (context: another stream), bound "
            f"{bound_ms:.4f} ms ({bound_by}, {pipe}; bytes {t_bytes:.4f} ms, operations {t_ops:.4f} ms at "
            f"{clock / 1e6:.0f} MHz: {count['operations']:g} an element, {count['merged']} injections merged, "
            f"{count['adds_on_alu']:g} on the integer pipe; SM clocks an element "
            + ", ".join(f"{k} {v:.4f}" for k, v in count["clocks"].items())
            + f"); {device_ms and bound_ms / device_ms:.1%} of the bound on the device; main-path launches {path}",
            flush=True,
        )
        rows.append({
            "name": label, "route": "cuda", "source": R1_SOURCE, "replaces": R1_REPLACES,
            "launches": sum(path.values()), "max_abs_err": errs[label], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "device_ms": device_ms, "bound_pipe": pipe, "operations_an_element": count["operations"],
            "context_torch_generator_ms": torch_ms,
        })
    return rows


def sort_path(dev) -> dict:
    """The sort family's main path through the public entry points; returns
    K4's launches in the one-segment calls and in the row sort."""
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.kernels import sort as ks

    def run(label: str, call):
        ks.SORT_LAUNCHES = 0
        out = call()
        torch.cuda.synchronize()
        launches = ks.SORT_LAUNCHES
        print(f"{label}: K4 launches {launches}", flush=True)
        _require(launches > 0, f"{label} ran without K4")
        return out, launches

    ht.random.seed(0)
    _r1_zero()
    x = ht.random.randn(SORT_N, split=0)
    torch.cuda.synchronize()
    _r1_read("sort_draw", 1, [SORT_N])
    xt = x.larray
    _require(xt.device == dev and x.dtype is ht.float32 and x.split == 0, "x is not a float32 split-0 array on the card")
    one = 0
    (v, i), n = run(f"ht.sort(x), x = randn({SORT_N})", lambda: ht.sort(x))
    one += n
    _require(v.split == 0 and i.dtype is ht.int64 and v.shape == i.shape == (SORT_N,), "sort result types")
    _require(torch.equal(i.larray, torch.sort(xt, stable=True).indices), "ht.sort indices differ from the stable argsort")
    _require(torch.equal(v.larray, xt[i.larray]) and bool((v.larray[1:] >= v.larray[:-1]).all()), "ht.sort values not sorted")
    (vd, idd), n = run("ht.sort(x, descending=True)", lambda: ht.sort(x, descending=True))
    one += n
    flipped = torch.sort(~ks.to_sortable(xt).long() & 0xFFFFFFFF, stable=True).indices
    _require(torch.equal(idd.larray, flipped), "descending indices differ from the stable argsort of the complement")
    _require(bool((vd.larray[1:] <= vd.larray[:-1]).all()), "descending values not sorted")

    (tv, ti), n = run(f"ht.topk(x, {TOPK_K})", lambda: ht.topk(x, TOPK_K))
    one += n
    _require(torch.equal(ti.larray, idd.larray[:TOPK_K]) and torch.equal(tv.larray, vd.larray[:TOPK_K]),
             "topk differs from the prefix of the descending sort")
    (tv, ti), n = run(f"ht.topk(x, {TOPK_K}, largest=False)", lambda: ht.topk(x, TOPK_K, largest=False))
    one += n
    _require(torch.equal(ti.larray, i.larray[:TOPK_K]) and torch.equal(tv.larray, v.larray[:TOPK_K]),
             "topk(largest=False) differs from the prefix of the sort")
    del vd, idd, i

    uf, n = run("ht.unique(x)", lambda: ht.unique(x))
    one += n
    _require(torch.equal(uf.larray, torch.unique_consecutive(v.larray)), "ht.unique(x) is not x's sorted distinct values")
    del v, uf
    _r1_zero()
    ints = ht.random.randint(0, 1000, (SORT_N,), split=0)
    torch.cuda.synchronize()
    _r1_read("sort_ints_draw", 1, [SORT_N])
    _require(ints.dtype is ht.int32, "randint did not give int32")
    u, n = run("ht.unique(randint(0, 1000))", lambda: ht.unique(ints))
    one += n
    _require(torch.equal(u.larray, torch.arange(1000, device=dev, dtype=torch.int32)), "unique of randint(0, 1000) is not 0..999")
    (u, inv), n = run("ht.unique(randint(0, 1000), return_inverse=True)", lambda: ht.unique(ints, return_inverse=True))
    one += n
    _require(inv.shape == (SORT_N,) and torch.equal(u.larray[inv.larray], ints.larray), "values[inverse] does not rebuild the input")
    del ints, u, inv, x, xt

    _r1_zero()
    X = ht.random.randn(SORT_ROWS, SORT_SEG, split=0)
    torch.cuda.synchronize()
    _r1_read("sort_rows_draw", 1, [SORT_ROWS * SORT_SEG])
    (V, I), rows = run(f"ht.sort(X, axis=1), X = randn({SORT_ROWS}, {SORT_SEG})", lambda: ht.sort(X, axis=1))
    _require(torch.equal(I.larray, torch.sort(X.larray, dim=1, stable=True).indices), "row sort indices differ from the stable argsort")
    _require(bool((V.larray[:, 1:] >= V.larray[:, :-1]).all()), "row sort values not sorted")
    return {"one_segment": one, "segments": rows}


# K4's kernels and the memsets of its state: all that ht.sort of float32
# may run on the card (csrc/radix_sort.cu)
K4_KERNELS = ("sweep_hist_kernel", "sweep_plan_kernel", "sweep_pass_kernel", "seg_sort_kernel", "Memset")
FIRST_SORT_MS = 18.8688  # ht.sort(randn(2^27)) on K4's first design (PERF.md §5)


def sort_timings(dev, launches: dict, errs: dict) -> list:
    """K4 in both regimes (the fused entry the main path launches) beside
    its plain version, torch.sort, the words-only entry and K4's first design,
    then the public calls end to end and a profile of ht.sort; returns
    K4's rows."""
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.kernels import sort as ks

    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    x = torch.randn(SORT_N, device=dev, generator=gen)
    X = torch.randn(SORT_ROWS, SORT_SEG, device=dev, generator=gen)
    rows = []
    for name, key, seg, library in (
        ("pair_sort_one_segment", "one_segment", None, lambda: torch.sort(x, stable=True)),
        ("pair_sort_segments", "segments", SORT_SEG, lambda: torch.sort(X, dim=1, stable=True)),
    ):
        vals = x if seg is None else X.reshape(-1)
        words = ks.to_sortable(vals)
        plan = ks.sort_plan(SORT_N, seg_len=seg)
        # in turns: old, new, new, old
        pr3_ms = _median_ms(lambda: ks._pair_sort_pr3(words, seg_len=seg), 10)
        ms = _median_ms(lambda: ks.fused_sort(vals, seg_len=seg), 10)
        words_ms = _median_ms(lambda: ks.pair_sort(words, seg_len=seg), 10)
        pr3_again_ms = _median_ms(lambda: ks._pair_sort_pr3(words, seg_len=seg), 10)
        plain_ms = _median_ms(lambda: ks.fused_sort_plain(vals, seg_len=seg), 2)
        library_ms = _median_ms(library, 10)
        # the fused entry: read each value once, write each value and int64 index once
        bound_ms, bound_by = _bound(16.0 * SORT_N, 0.0)
        model_ms = plan["hbm_bytes"] / HBM_BYTES_PER_S * 1e3
        print(
            f"{name} (K4 fused, {plan['path']}, n={SORT_N} float32{'' if seg is None else f' in segments of {seg}'}, "
            f"values and int64 indices): {ms:.4f} ms, torch.sort(stable=True) {library_ms:.4f} ms "
            f"(K4 faster: {ms <= library_ms}), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, 16 B a "
            f"pair); words in and out (12 B a pair): this design {words_ms:.4f} ms, the first design {pr3_ms:.4f} / "
            f"{pr3_again_ms:.4f} ms; pass model {plan['passes']} passes, {plan['hbm_bytes'] / 1e9:.4f} GB, "
            f"{model_ms:.4f} ms at 3.35 TB/s ({plan['hbm_bytes'] / (ms * 1e-3) / 1e9:.1f} GB/s of model bytes "
            f"achieved)", flush=True,
        )
        rows.append({
            "name": name, "route": "cuda", "source": "heat_tpu_torch/csrc/radix_sort.cu",
            "replaces": "heat_tpu/kernels/sort.py:253", "launches": launches[key], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "words_ms": words_ms, "pr3_ms": min(pr3_ms, pr3_again_ms),
        })
        del words
    rows[0]["network_steps"] = _network_step_timings(dev, gen)
    A = ht.array(x, split=0)
    floor_ms = ks.sort_plan(SORT_N)["floor_bytes"] / HBM_BYTES_PER_S * 1e3
    sort_ms = _median_ms(lambda: ht.sort(A), 5)
    desc_ms = _median_ms(lambda: ht.sort(A, descending=True), 5)
    unique_ms = _median_ms(lambda: ht.unique(A), 5)
    topk_ms = _median_ms(lambda: ht.topk(A, TOPK_K), 5)
    torch_topk_ms = _median_ms(lambda: torch.topk(x, TOPK_K), 5)
    rows_ms = _median_ms(lambda: ht.sort(ht.array(X, split=0), axis=1), 5)
    print(
        f"ht.sort(randn({SORT_N})): {sort_ms:.4f} ms (median of 5, CUDA events; on the first design: "
        f"{FIRST_SORT_MS} ms), floor {floor_ms:.4f} ms (read 4, write 4 + 8 B an element); descending {desc_ms:.4f} ms; "
        f"ht.sort(randn({SORT_ROWS}, {SORT_SEG}), axis=1): {rows_ms:.4f} ms; ht.unique: {unique_ms:.4f} ms; "
        f"ht.topk(x, {TOPK_K}): {topk_ms:.4f} ms beside torch.topk {torch_topk_ms:.4f} ms", flush=True,
    )
    kernels = profile_breakdown(f"ht.sort(randn({SORT_N}))", lambda: ht.sort(A))
    others = [k for k in kernels if not any(tag in k for tag in K4_KERNELS)]
    print(f"ht.sort(randn({SORT_N})) ran {len(kernels)} kinds of device work, none outside K4: {not others}",
          flush=True)
    _require(not others, f"ht.sort of float32 ran device work outside K4: {others}")
    return rows


def _network_step_timings(dev, gen) -> dict:
    """The local steps of the world's sort networks alone on the card: a
    columnsort step of ``sort_1gb`` (B = 2^25 pairs) and an odd-even merge
    of ``sort_1gb_ragged`` (2(2^25 + 1) pairs), each as ``block_sort`` of
    (float32 value, int64 global index) and as the K4 ``pair_sort`` inside
    it (4 index bytes), beside ``torch.sort(stable=True)`` of the values;
    median of 10 CUDA-event readings. Returns the times by step."""
    import torch

    from heat_tpu_torch.kernels import sort as ks

    out = {}
    for label, n, extent in (("columnsort_step", SORT_N // WORLD, SORT_N),
                             ("oddeven_merge", 2 * (SORT_N // WORLD + 1), SORT_N + 2)):
        v = torch.randn(n, device=dev, generator=gen)
        idx = torch.randperm(n, device=dev, generator=gen) + (extent - n)
        keys, pays = ks.sort_key(v), idx.to(torch.int32)
        step_ms = _median_ms(lambda: ks.block_sort((v, idx), 0, 2, extent=extent), 10)
        k4_ms = _median_ms(lambda: ks.pair_sort(keys, pays, n, 4), 10)
        library_ms = _median_ms(lambda: torch.sort(v, stable=True), 10)
        bound_ms = (n * (4 + 8) * 2) / HBM_BYTES_PER_S * 1e3  # float32 values and int64 indices in and out
        print(f"K4 at the networks' {label} ({n} pairs of float32 randn and int64 index, alone on the card): "
              f"block_sort {step_ms:.4f} ms, its pair_sort (pay_bytes=4) {k4_ms:.4f} ms, torch.sort(stable=True) "
              f"of the values {library_ms:.4f} ms, bound {bound_ms:.4f} ms (24 B a pair)", flush=True)
        out[label] = {"n": n, "block_sort_ms": step_ms, "pair_sort_ms": k4_ms, "library_ms": library_ms,
                      "bound_ms": bound_ms}
        del v, idx, keys, pays
    return out


def _recovered(labels, k: int) -> bool:
    """Every one of k equal blocks of ``labels`` holds one label, and the k
    labels differ."""
    import torch

    blocks = labels.reshape(k, -1)
    firsts = blocks[:, 0]
    return bool((blocks == firsts[:, None]).all()) and len(torch.unique(firsts)) == k


def kmeans_path(dev) -> int:
    """The KMeans main path through the public entry points; returns K3's
    launches in the full-size fit."""
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.cluster import _cuda_assign as ca

    ht.random.seed(0)
    _r1_zero()
    X = ht.random.randn(KM_N, KM_D, split=0)
    torch.cuda.synchronize()
    _r1_read("kmeans_draw", 1, [KM_N * KM_D])
    _require(X.larray.device == dev and X.dtype is ht.float32 and X.split == 0, "X is not a float32 split-0 array on the card")
    ca.ASSIGN_LAUNCHES = 0
    _r1_zero()
    km = ht.cluster.KMeans(n_clusters=KM_K, init="kmeans++", max_iter=KM_ITERS, tol=-1.0, random_state=0).fit(X)
    torch.cuda.synchronize()
    # k-means++: the first row's randint, then the candidates' uniform of each later step
    _r1_read("kmeans_fit", KM_K, [1] + [2 + int(math.log(KM_K))] * (KM_K - 1))
    launches = ca.ASSIGN_LAUNCHES
    centers, labels = km.cluster_centers_.larray, km.labels_.larray
    print(
        f"KMeans({KM_N}x{KM_D}, k={KM_K}, kmeans++).fit: n_iter {km.n_iter_}, K3 launches {launches}, "
        f"inertia {km.inertia_:.6e}, labels split {km.labels_.split} dtype {km.labels_.dtype.__name__}", flush=True,
    )
    _require(km.n_iter_ == KM_ITERS and launches == km.n_iter_, "the fit did not run every Lloyd step through K3")
    _require(tuple(centers.shape) == (KM_K, KM_D) and tuple(labels.shape) == (KM_N,), "fit result shapes")
    _require(bool(torch.isfinite(centers).all()) and math.isfinite(km.inertia_), "non-finite centers or inertia")
    _require(int(labels.min()) >= 0 and int(labels.max()) < KM_K, "labels out of range")
    _require(torch.equal(km.predict(X).larray, labels), "predict(X) differs from labels_")
    del X, km, labels

    # eight well-separated blobs of the same size, with known means
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    # means 8·sqrt(2·64) apart against a spread of sqrt(64): k-means++ seeding
    # finds each blob, where the axis layout of phase 3 is too tight for it
    x = _blobs(gen, KM_N, torch.randn(KM_K, KM_D, device=dev, generator=gen) * 8.0)
    B = ht.array(x, split=0)
    km = ht.cluster.KMeans(n_clusters=KM_K, init="kmeans++", random_state=1).fit(B)
    ok = _recovered(km.labels_.larray, KM_K)
    print(f"blobs, kmeans++: n_iter {km.n_iter_}, every blob one distinct cluster: {ok}", flush=True)
    _require(ok, "kmeans++ did not recover the eight blobs")
    init = x[:: KM_N // KM_K].contiguous()
    km = ht.cluster.KMeans(n_clusters=KM_K, init=ht.array(init)).fit(B)
    c = init
    for _ in range(km.n_iter_):
        sums, counts, inertia = ca.fused_assign_plain(x, c)
        c = torch.where(counts[:, None] > 0, sums / torch.clamp_min(counts[:, None], 1), c)
    ec = _rel(km.cluster_centers_.larray, c)
    ei = abs(km.inertia_ - float(inertia)) / float(inertia)
    print(
        f"blobs, one point per blob: n_iter {km.n_iter_}; against a plain Lloyd loop: centers rel "
        f"{ec:.3e} (tol {TOL_SUMS}), inertia rel {ei:.3e} (tol {TOL_INERTIA})", flush=True,
    )
    _require(ec <= TOL_SUMS and ei <= TOL_INERTIA, "the fit disagrees with a Lloyd loop on the plain assignment")
    _require(_recovered(km.labels_.larray, KM_K), "the fit from one point per blob did not recover the blobs")
    del x, B, km

    # the reference benchmark's configuration (BASELINE.md, heat benchmarks/cb/cluster.py)
    data = ht.utils.data.create_spherical_dataset(5000, radius=0.5, offset=6.0, random_state=1)
    _require(tuple(data.shape) == (20000, 3) and data.larray.device == dev, "spherical data shape or device")
    for cls in (ht.cluster.KMeans, ht.cluster.KMedians, ht.cluster.KMedoids):
        ca.ASSIGN_LAUNCHES = 0
        est = cls(n_clusters=4, init="kmeans++", random_state=0).fit(data)
        ok = _recovered(est.labels_.larray, 4)
        print(
            f"reference config 4x5000x3, {cls.__name__}: n_iter {est.n_iter_}, K3 launches "
            f"{ca.ASSIGN_LAUNCHES}, every cluster recovered: {ok}", flush=True,
        )
        _require(ok, f"{cls.__name__} did not recover the four spherical clusters")
        _require(cls is not ht.cluster.KMeans or ca.ASSIGN_LAUNCHES == est.n_iter_, "KMeans ran without K3")
    return launches


def _orthonormal_err(x) -> float:
    import torch

    x = x.double()
    return float((x.T @ x - torch.eye(x.shape[1], dtype=x.dtype, device=x.device)).abs().max())


# (σ relative error, error estimate) bounds for an exactly rank-8 operand.
# The 2-pass form is exact up to float32 rounding. The one-view form is
# exact only in exact arithmetic: in float32 its Gram orthonormalization
# turns the null directions of Y = AΩ into near-zero columns of Q, the
# solve (ΨQ)⁺W amplifies rounding there, and the loss grows with the size
# of A. heat_tpu's one-view does the same; its small-size tolerance holds
# at 1000 x 777 only.
RANK8_TOL = {False: (1e-4, 1e-3), True: (2e-2, 0.25)}


def _check_rank8(ht, A, sigma_ref, what: str, tol=None) -> None:
    import torch

    ref = torch.tensor(sigma_ref, dtype=torch.float64)
    for single_pass in (False, True):
        s_tol, e_tol = (tol or RANK8_TOL)[single_pass]
        U, sigma, V, err = ht.linalg.hsvd_rank(A, MAXRANK, compute_sv=True, single_pass=single_pass)
        s = sigma.larray.double().cpu()
        rel = float(((s[: len(ref)] - ref).abs() / ref).max())
        print(
            f"{what} single_pass={single_pass}: sigma rel err {rel:.3e} (tol {s_tol}), "
            f"err {float(err):.3e} (tol {e_tol})", flush=True,
        )
        _require(rel <= s_tol, f"{what}: singular values off (single_pass={single_pass})")
        _require(0.0 <= float(err) <= e_tol, f"{what}: error estimate {float(err)} (single_pass={single_pass})")
        # columns past the rank carry σ ≈ 0 and may be zero: check the first 8
        _require(
            max(_orthonormal_err(U.larray[:, :8]), _orthonormal_err(V.larray[:, :8])) <= 1e-4,
            f"{what}: factors not orthonormal",
        )


def main_path(dev) -> dict:
    """The port's main path through its public entry points; returns the
    kernel launch counts of the full-size calls."""
    import numpy as np
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.core.linalg import _cuda_sketch as cs

    ht.random.seed(0)
    _r1_zero()
    A = ht.random.randn(M, N, split=0)
    torch.cuda.synchronize()
    _r1_read("hsvd_draw", 1, [M * N])
    _require(A.larray.device == dev and A.dtype is ht.float32 and A.split == 0, "A is not a float32 split-0 array on the card")
    launches = {}
    for single_pass, kernel in ((False, "sketch_with_norm"), (True, "dual_sketch_with_norm")):
        cs.SKETCH_LAUNCHES = cs.DUAL_LAUNCHES = cs.SKETCH_SM90_LAUNCHES = cs.DUAL_SM90_LAUNCHES = 0
        _r1_zero()
        U, sigma, V, err = ht.linalg.hsvd_rank(A, MAXRANK, compute_sv=True, single_pass=single_pass)
        torch.cuda.synchronize()
        # the sketch operators: g (2-pass), g and Ω (one-view), heat_tpu's draws
        _r1_read("hsvd_one_view" if single_pass else "hsvd_2pass", 1 + single_pass)
        counts = {"sketch_with_norm": cs.SKETCH_LAUNCHES, "dual_sketch_with_norm": cs.DUAL_LAUNCHES,
                  "sketch_sm90": cs.SKETCH_SM90_LAUNCHES, "dual_sketch_sm90": cs.DUAL_SM90_LAUNCHES}
        launches[kernel] = counts[kernel]
        s = sigma.larray
        ou, ov = _orthonormal_err(U.larray), _orthonormal_err(V.larray)
        print(
            f"hsvd_rank({M}x{N}, {MAXRANK}, single_pass={single_pass}): launches {counts}, "
            f"U {tuple(U.shape)} V {tuple(V.shape)}, orthonormality {ou:.2e}/{ov:.2e} (tol 1e-4), "
            f"sigma[0]={float(s[0]):.4f} sigma[-1]={float(s[-1]):.4f}, err={float(err):.6f}", flush=True,
        )
        _require(counts[kernel] > 0, f"the main path ran without kernel {kernel}")
        _require(counts["sketch_sm90" if not single_pass else "dual_sketch_sm90"] == counts[kernel],
                 f"hsvd_rank(single_pass={single_pass}) ran {'K2' if single_pass else 'K1'} off its Hopper kernel")
        _require(U.shape == (M, MAXRANK) and V.shape == (N, MAXRANK) and sigma.shape == (MAXRANK,), "factor shapes")
        _require(bool(torch.isfinite(U.larray).all() and torch.isfinite(V.larray).all() and torch.isfinite(s).all()), "non-finite factors")
        # the 2-pass estimate is exact, so at most 1; the one-view one is a
        # sampled estimate and can exceed 1 on flat spectra such as this
        _require(bool((s[:-1] >= s[1:]).all() and s[-1] > 0), "spectrum not positive and descending")
        _require(0.0 < float(err) <= (float("inf") if single_pass else 1.0), f"error estimate {float(err)} out of range")
        _require(max(ou, ov) <= 1e-4, "factors not orthonormal")
    del A, U, V

    # an exactly rank-8 operand of the same size, L @ R built on the card
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    left, _ = torch.linalg.qr(torch.randn(M, 8, device=dev, generator=gen))
    right, _ = torch.linalg.qr(torch.randn(N, 8, device=dev, generator=gen))
    sig = torch.tensor(RANK8_SIGMA, device=dev)
    _check_rank8(ht, ht.array((left * sig) @ right.T, split=0), RANK8_SIGMA, f"rank-8 {M}x{N}")

    # a small input against numpy's SVD
    rng = np.random.default_rng(3)
    small = (rng.standard_normal((RAGGED[0], 8)) * RANK8_SIGMA) @ rng.standard_normal((8, RAGGED[1]))
    sigma_np = np.linalg.svd(small, compute_uv=False)[:8]
    small_tol = {sp: RANK8_TOL[False] for sp in (False, True)}
    _check_rank8(ht, ht.array(small.astype(np.float32), split=0), list(sigma_np), f"rank-8 {RAGGED[0]}x{RAGGED[1]} vs numpy", small_tol)
    return launches


def _count_bytes(comm) -> dict:
    """Wrap ``comm``'s collectives so that each adds the bytes this rank
    puts into it to ``moved[name]``; returns ``moved``."""
    moved = {}
    for method, key in (("allgather", "all-gather"), ("alltoall", "all-to-all"), ("allreduce", "all-reduce"),
                        ("bcast", "broadcast"), ("ring_exchange", "collective-permute"),
                        ("permute", "collective-permute")):
        def wrapped(t, *args, _real=getattr(comm, method), _key=key, **kwargs):
            moved[_key] = moved.get(_key, 0) + t.numel() * t.element_size()
            return _real(t, *args, **kwargs)
        setattr(comm, method, wrapped)
    return moved


def _timed(fn, events: list):
    """``fn`` wrapped so that each call leaves a pair of CUDA events around
    its device work in ``events`` (read after a sync); the wrapper's
    ``__wrapped__`` is ``fn``."""
    import functools

    import torch

    @functools.wraps(fn)
    def timed(*args, **kwargs):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        stop.record()
        events.append((start, stop))
        return out

    return timed


def _time_level0(svdtools, events: list) -> None:
    """Wrap ``svdtools._level0`` so that each call leaves a pair of CUDA
    events around its device work in ``events``."""
    svdtools._level0 = _timed(svdtools._level0, events)


def _world_shard(rank: int, shape, split: int, rank8: bool):
    """This rank's shard: a standard normal draw from the rank's own seed,
    or its rows (split 0) or columns (split 1) of an exactly rank-8 matrix
    (L·diag(σ)·Rᵀ, L and R drawn from one seed on every rank,
    orthonormalized on the card)."""
    import torch

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    if not rank8:
        gen.manual_seed(1000 + rank)
        return torch.randn(shape, device=dev, generator=gen)
    gen.manual_seed(2)
    glob = [shape[0], shape[1]]
    glob[split] *= WORLD
    left, _ = torch.linalg.qr(torch.randn(glob[0], 8, device=dev, generator=gen))
    right, _ = torch.linalg.qr(torch.randn(glob[1], 8, device=dev, generator=gen))
    block = slice(rank * shape[split], (rank + 1) * shape[split])
    left, right = (left[block], right) if split == 0 else (left, right[block])
    return (left * torch.tensor(RANK8_SIGMA, device=dev)) @ right.T


def _alone(rank: int, fn, reps: int = 3) -> float:
    """``fn``'s CUDA-event median on this rank while the other ranks wait
    at a barrier: the ranks take turns."""
    import torch.distributed as dist

    ms = None
    for q in range(WORLD):
        dist.barrier()
        if q == rank:
            ms = _median_ms(fn, reps)
        dist.barrier()
    return ms


def _world_config(ht, cs, svdtools, comm, moved: dict, level0: list, rank: int, config, profile: bool) -> dict:
    """One configuration of the world phase on this rank: the counted
    call, its checks, level 0 alone, then the timed calls (and, with
    ``profile``, one call profiled on rank 0)."""
    import torch
    import torch.distributed as dist

    name, shape, split, single_pass, rank8 = config
    A = ht.array(_world_shard(rank, shape, split, rank8), is_split=split)
    gshape = (WORLD * shape[0], shape[1]) if split == 0 else (shape[0], WORLD * shape[1])
    _require(A.shape == gshape and A.split == split and A.larray.is_cuda, f"{name}: A is not the {gshape} split-{split} array on the card")
    cs.SKETCH_LAUNCHES = cs.DUAL_LAUNCHES = cs.SKETCH_SM90_LAUNCHES = cs.DUAL_SM90_LAUNCHES = 0
    comm.counts.clear()
    moved.clear()
    level0.clear()
    U, sigma, V, err = ht.linalg.hsvd_rank(A, MAXRANK, compute_sv=True, single_pass=single_pass)
    torch.cuda.synchronize()
    launches = {"sketch_with_norm": cs.SKETCH_LAUNCHES, "sketch_sm90": cs.SKETCH_SM90_LAUNCHES,
                "dual_sketch_with_norm": cs.DUAL_LAUNCHES, "dual_sketch_sm90": cs.DUAL_SM90_LAUNCHES}
    counts, nbytes = dict(comm.counts), dict(moved)
    kernel, other = ("dual_sketch_with_norm", "sketch_with_norm") if single_pass else ("sketch_with_norm", "dual_sketch_with_norm")
    sm90 = "dual_sketch_sm90" if single_pass else "sketch_sm90"
    _require(launches[kernel] > 0 and launches[sm90] == launches[kernel] and launches[other] == 0,
             f"{name} rank {rank}: launches {launches}, not all on {kernel}'s Hopper kernel")
    _require(U.shape == (gshape[0], MAXRANK) and V.shape == (gshape[1], MAXRANK) and sigma.shape == (MAXRANK,)
             and U.split == 0 and V.split == 0, f"{name}: factor shapes or splits")
    s = sigma.larray
    _require(bool(torch.isfinite(U.larray).all() and torch.isfinite(V.larray).all() and torch.isfinite(s).all()),
             f"{name}: non-finite factors")
    cols = 8 if rank8 else MAXRANK  # past rank 8 σ ≈ 0 and the columns may be zero

    def gram_err(x):
        xl = x.larray[:, :cols].double()
        g = comm.allreduce(xl.T @ xl)
        return float((g - torch.eye(cols, dtype=g.dtype, device=g.device)).abs().max())

    ou, ov = gram_err(U), gram_err(V)
    _require(max(ou, ov) <= 1e-4, f"{name}: factors not orthonormal across ranks ({ou:.2e}, {ov:.2e})")
    every = comm.allgather(s.reshape(1, -1))
    _require(all(torch.equal(every[q], every[0]) for q in range(WORLD)), f"{name}: sigma differs between ranks")
    e = float(err)
    if rank8:
        s_tol, e_tol = RANK8_TOL[single_pass]
        ref = torch.tensor(RANK8_SIGMA, dtype=torch.float64)
        rel = float(((s[:8].double().cpu() - ref).abs() / ref).max())
        _require(rel <= s_tol and 0.0 <= e <= e_tol, f"{name}: sigma rel err {rel:.3e} (tol {s_tol}), err {e} (tol {e_tol})")
    else:
        rel = None
        _require(bool((s[:-1] >= s[1:]).all() and s[-1] > 0), f"{name}: spectrum not positive and descending")
        _require(0.0 < e <= (float("inf") if single_pass else 1.0), f"{name}: error estimate {e} out of range")
    level0_first = [a.elapsed_time(b) for a, b in level0]
    del U, sigma, V, err
    # level 0 and the one-view copy of Sᵀ on this rank alone, the other
    # ranks waiting at a barrier (inside the call the card time-slices
    # the four ranks' contexts)
    transposed = split == 0
    m, n = (gshape[1], gshape[0]) if transposed else gshape
    params = svdtools._level0_params(m, n, WORLD, MAXRANK, 5, None, single_pass, A.larray)
    level0_alone_ms = _alone(rank, lambda: svdtools._level0(A.larray, transposed, *params))
    copy_ms = _alone(rank, lambda: A.larray.T.contiguous()) if single_pass and transposed else None
    # the world's call: CUDA events on each rank between barriers
    call_ms, level0_ms = [], []
    for _ in range(WORLD_REPS):
        level0.clear()
        dist.barrier()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ht.linalg.hsvd_rank(A, MAXRANK, compute_sv=True, single_pass=single_pass)
        stop.record()
        torch.cuda.synchronize()
        dist.barrier()
        call_ms.append(start.elapsed_time(stop))
        level0_ms.append(sum(a.elapsed_time(b) for a, b in level0))
    if profile and rank == 0:
        profile_breakdown(f"world {name} on rank 0", lambda: ht.linalg.hsvd_rank(A, MAXRANK, compute_sv=True))
    elif profile:
        ht.linalg.hsvd_rank(A, MAXRANK, compute_sv=True)
        torch.cuda.synchronize()
    return {
        "launches": launches, "counts": counts, "bytes": nbytes, "orthonormality": (ou, ov),
        "sigma": [float(x) for x in s.cpu()], "sigma_rel_err": rel, "err": e, "copy_ms": copy_ms,
        "call_ms": statistics.median(call_ms), "level0_ms": statistics.median(level0_ms),
        "level0_first_ms": level0_first, "level0_alone_ms": level0_alone_ms,
    }


def _world_ms(fn, reps: int) -> float:
    """``fn``'s time on this rank (CUDA events on its stream around each
    call, the ranks starting together after a barrier), median of ``reps``."""
    import torch
    import torch.distributed as dist

    times = []
    for _ in range(reps):
        dist.barrier()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        dist.barrier()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _every_rank_ok(comm, ok: bool, what: str) -> None:
    """Fail every rank where any rank's check failed (one all-reduce), so
    that no rank waits at the next collective for one that has raised."""
    import torch

    bad = int(comm.allreduce(torch.tensor([0 if ok else 1])).item())
    _require(bad == 0, f"{what} (failed on {bad} rank(s))")


WORLD_RANDOM = (WORLD * M, N)  # one global randn of four north-star shards, split 0


def _world_random(ht, comm, moved: dict, rank: int, dev) -> dict:
    """One global ``ht.random.randn(4 · 65536, 8192, split=0)``: each rank
    must launch R1 once, for exactly its chunk's elements, issue no
    collective, and hold the chunk of heat_tpu's draw (the first and last
    R1_SAMPLE elements of every rank's chunk against the plain version at
    their global flat indices); then the same of ``randn(65536, 8192,
    split=1)``."""
    import torch

    from heat_tpu_torch.core import _threefry as tf
    from heat_tpu_torch.kernels import threefry as kt

    ht.random.seed(0)
    key = tf.fold_in(tf.fold_in(tf.seed_key(0), 0), 0)
    chunk = tf.Chunk.of(WORLD_RANDOM, 0, comm)
    _r1_zero()
    comm.counts.clear()
    moved.clear()
    x = ht.random.randn(*WORLD_RANDOM, split=0)
    torch.cuda.synchronize()
    launches, elements, counts = kt.THREEFRY_LAUNCHES, list(kt.THREEFRY_ELEMENTS), dict(comm.counts)
    ok = launches == 1 and elements == [chunk.numel] and tuple(x.lshape) == chunk.lshape and not counts
    try:
        err = _r1_sample_err(kt, x.larray, "normal", key, chunk, torch.float32, (0.0, 1.0), f"world randn, rank {rank}")
    except RuntimeError:
        ok, err = False, float("nan")
    _every_rank_ok(comm, ok, "world randn: a rank launched R1 other than once for its chunk, issued a collective, "
                   "or differs from the plain version")
    del x
    ms = _world_ms(lambda: ht.random.randn(*WORLD_RANDOM, split=0), 3)
    # the north star split 1: each rank its 65536 rows of 2048 columns (R1's
    # outer > 1 path; rank 1's chunk is random_timings' split-1 row)
    ht.random.seed(0)
    chunk1 = tf.Chunk.of((M, N), 1, comm)
    _r1_zero()
    comm.counts.clear()
    moved.clear()
    y = ht.random.randn(M, N, split=1)
    torch.cuda.synchronize()
    split1 = {"launches": kt.THREEFRY_LAUNCHES, "elements": list(kt.THREEFRY_ELEMENTS)}
    ok = (split1["launches"] == 1 and split1["elements"] == [chunk1.numel] and tuple(y.lshape) == chunk1.lshape
          and not comm.counts)
    try:
        split1["err"] = _r1_sample_err(kt, y.larray, "normal", key, chunk1, torch.float32, (0.0, 1.0),
                                       f"world randn split 1, rank {rank}")
    except RuntimeError:
        ok, split1["err"] = False, float("nan")
    _every_rank_ok(comm, ok, "world randn split 1: a rank launched R1 other than once for its chunk, issued a "
                   "collective, or differs from the plain version")
    del y
    split1["ms"] = _world_ms(lambda: ht.random.randn(M, N, split=1), 3)
    torch.cuda.empty_cache()
    return {"launches": launches, "elements": elements, "ms": ms, "err": err, "start": chunk.start, "split1": split1}


def _world_kmeans(ht, comm, moved: dict, rank: int, dev) -> dict:
    """BASELINE #4 at world size 4 on this one card: each rank's 15,625,000 x
    64 float32 shard from its own seed, ``KMeans(8, kmeans++)`` for 20
    iterations and ``predict``; then eight planted blobs, two a rank."""
    import functools

    import torch

    from heat_tpu_torch.cluster import _cuda_assign as ca
    from heat_tpu_torch.cluster._kcluster import _kmeanspp, _Rows, _seed_key, make_fit_loop
    from heat_tpu_torch.cluster.kmeans import _lloyd_step

    gen = torch.Generator(device=dev)
    gen.manual_seed(3000 + rank)
    X = ht.array(torch.randn(KM_N, KM_D, device=dev, generator=gen), is_split=0)
    _require(X.shape == (WORLD * KM_N, KM_D) and X.split == 0 and X.larray.is_cuda, "KMeans: X is not split 0 on the card")

    def fit():
        return ht.cluster.KMeans(n_clusters=KM_K, init="kmeans++", max_iter=KM_ITERS, tol=-1.0, random_state=0).fit(X)

    ca.ASSIGN_LAUNCHES = 0
    comm.counts.clear()
    moved.clear()
    km = fit()
    torch.cuda.synchronize()
    launches, counts, nbytes = ca.ASSIGN_LAUNCHES, dict(comm.counts), dict(moved)
    _require(km.n_iter_ == KM_ITERS and launches == km.n_iter_,
             f"KMeans rank {rank}: n_iter {km.n_iter_}, K3 launches {launches}")
    centers = km.cluster_centers_.larray
    every = comm.allgather(centers[None])
    same = all(torch.equal(every[q], every[0]) for q in range(WORLD))
    finite = bool(torch.isfinite(centers).all()) and math.isfinite(km.inertia_)
    predicted = torch.equal(km.predict(X).larray, km.labels_.larray) and km.labels_.split == 0
    _every_rank_ok(comm, same and finite and predicted, "KMeans across ranks: centers not equal bit for bit on every "
                   "rank, not finite, or predict(X) not labels_")
    fit_ms = _world_ms(fit, 2)
    x, rows = X.larray, _Rows.of(X)
    seed_ms = _world_ms(lambda: _kmeanspp(x, KM_K, _seed_key(KM_K), rows), 2)
    loop = make_fit_loop(functools.partial(_lloyd_step, rows=rows), -1.0, KM_ITERS, True)
    loop_ms = _world_ms(lambda: loop(x, centers), 3)
    inertia = km.inertia_
    del X, x, km, every

    # eight blobs of the same size, two a rank, means from one seed
    gen_m = torch.Generator(device=dev)
    gen_m.manual_seed(6)
    means = torch.randn(KM_K, KM_D, device=dev, generator=gen_m) * 8.0
    per = KM_K // WORLD
    gen.manual_seed(4000 + rank)
    x = _blobs(gen, KM_N, means[rank * per : (rank + 1) * per])
    B = ht.array(x, is_split=0)

    def recovered(labels) -> bool:
        blocks = labels.reshape(per, -1)
        local = bool((blocks == blocks[:, :1]).all())
        firsts = comm.allgather(blocks[:, 0].contiguous())
        return bool(comm.allreduce(torch.tensor([int(local)], device=dev)).item() == WORLD) and \
            len(torch.unique(firsts)) == KM_K

    km = ht.cluster.KMeans(n_clusters=KM_K, init="kmeans++", random_state=1).fit(B)
    pp_iter, pp_ok = km.n_iter_, recovered(km.labels_.larray)
    _require(pp_ok, "kmeans++ across ranks did not recover the eight blobs")
    init = comm.allgather(x[:: KM_N // per].contiguous())  # the first row of each blob
    km = ht.cluster.KMeans(n_clusters=KM_K, init=ht.array(init)).fit(B)
    c = init
    for _ in range(km.n_iter_):
        sums, cnt, inr = ca.fused_assign_plain(x, c)
        packed = comm.allreduce(torch.cat([sums.reshape(-1), cnt, inr.reshape(1)]).double()).float()
        sums, cnt, inr = packed[: KM_K * KM_D].reshape(KM_K, KM_D), packed[KM_K * KM_D : -1], packed[-1]
        c = torch.where(cnt[:, None] > 0, sums / torch.clamp_min(cnt[:, None], 1), c)
    ec = _rel(km.cluster_centers_.larray, c)
    ei = abs(km.inertia_ - float(inr)) / float(inr)
    _require(ec <= TOL_SUMS and ei <= TOL_INERTIA and recovered(km.labels_.larray),
             f"KMeans across ranks from one point per blob: centers rel {ec:.3e}, inertia rel {ei:.3e}")
    out = {"launches": launches, "n_iter": KM_ITERS, "counts": counts, "bytes": nbytes, "inertia": inertia,
           "fit_ms": fit_ms, "seed_ms": seed_ms, "loop_ms": loop_ms, "pp_iter": pp_iter, "blob_iter": km.n_iter_,
           "blob_err": (ec, ei)}
    del x, B, km
    return out


# ring attention with q split 2 over the ranks: (name, (B, H, S, D), dtype, causal)
WORLD_ATTENTION = (
    ("ra_f32_causal", RA, "float32", True),
    ("ra_f32", RA, "float32", False),
    ("ra_bf16_causal", RA, "bfloat16", True),
    ("rab_bf16_causal", RAB, "bfloat16", True),
    ("ra_f32_causal_4097", RA[:2] + (4097,) + RA[3:], "float32", True),  # ragged: 1025 rows a rank, 1022 on the last
)


def _world_attention(ht, comm, moved: dict, rank: int, dev) -> dict:
    """``ring_attention`` with q, k and v split along the sequence over the
    ranks, each rank's shards from its own seed: K9's launches on this rank
    (r + 1 causal, WORLD not), all on the Hopper path, and the gathered
    output against the plain version on the whole q, k, v."""
    import torch

    from heat_tpu_torch.kernels import attention as ka

    gen = torch.Generator(device=dev)
    out = {}
    for name, shape, dt, causal in WORLD_ATTENTION:
        dtype = getattr(torch, dt)
        lshape = comm.chunk(shape, 2)[1]
        gen.manual_seed(5000 + rank)
        q, k, v = (ht.array(torch.randn(lshape, device=dev, generator=gen).to(dtype), is_split=2) for _ in range(3))
        ka.ATTENTION_LAUNCHES = ka.ATTENTION_SM90_LAUNCHES = 0
        comm.counts.clear()
        moved.clear()
        comm.staged_bytes = 0
        o = ht.nn.ring_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        launches, sm90 = ka.ATTENTION_LAUNCHES, ka.ATTENTION_SM90_LAUNCHES
        counts, nbytes, staged = dict(comm.counts), dict(moved), comm.staged_bytes
        want = rank + 1 if causal else WORLD
        _every_rank_ok(comm, launches == want and sm90 == launches and o.split == 2 and o.gshape == shape
                       and o.larray.dtype == dtype and bool(torch.isfinite(o.larray).all()),
                       f"ring_attention {name}: K9 launches, Hopper path, split, shape or values")
        sizes = comm.lshape_map(shape, 2)[:, 2]
        qw, kw, vw, ow = (comm.allgather(t.larray, 2, sizes) for t in (q, k, v, o))
        err = torch.zeros(2, device=dev, dtype=torch.float64)
        if rank == 0:
            ro, _ = ka.flash_attention_plain(qw, kw, vw, causal)
            err = torch.tensor(_o_errors(ka, ow, ro, qw, kw, vw, causal), device=dev, dtype=torch.float64)
            del ro
        err = comm.bcast(err, root=0)
        del qw, kw, vw, ow
        _require(float(err[0]) <= 1, f"ring_attention {name} disagrees with the plain version ({float(err[1]):.3e})")
        ms = _world_ms(lambda: ht.nn.ring_attention(q, k, v, causal=causal), 3)
        out[name] = {"launches": launches, "sm90": sm90, "err": float(err[0]), "abs_err": float(err[1]),
                     "counts": counts, "bytes": nbytes, "staged": staged, "ms": ms}
        if name in WORLD_BACKWARD:
            out[name]["backward"] = _world_attention_backward(ht, comm, q, k, v, name, shape, causal, rank, dev)
            print(f"world ring_attention {name} backward on rank {rank}: {out[name]['backward']}, forward "
                  f"{ms:.4f} ms; {CARD_LINE.get('card', '')}", flush=True)
        del q, k, v, o
        torch.cuda.empty_cache()
    return out


WORLD_BACKWARD = ("ra_f32_causal", "ra_bf16_causal", "ra_f32_causal_4097")
# the ring's gradients against the plain version's autograd on the whole q, k
# and v, max |Δ| over the largest |gradient|: float32 is both sides' float32
# rounding; bfloat16 also rounds o (which D = rowsum(dO ⊙ O) reads) and the
# gradients themselves to bfloat16 (2^-8 relative)
TOL_RING_GRAD = {"float32": 1e-4, "bfloat16": 2.0**-5}


def _world_attention_backward(ht, comm, q, k, v, name: str, shape, causal: bool, rank: int, dev) -> dict:
    """The backward of ``ring_attention`` with q, k and v split: dQ, dK and
    dV for a seeded output gradient, p collective-permutes a rank, K9 r + 1
    times (causal) in its forward; the gathered gradients held on rank 0
    against the plain version's autograd on the whole q, k and v; the
    backward's time (CUDA events, the graph kept across the repeats)."""
    import torch

    from heat_tpu_torch.kernels import attention as ka

    leaves = [t.larray.requires_grad_() for t in (q, k, v)]
    ka.ATTENTION_LAUNCHES = 0
    o = ht.nn.ring_attention(q, k, v, causal=causal)
    fwd_launches = ka.ATTENTION_LAUNCHES
    gen = torch.Generator(device=dev)
    gen.manual_seed(6000 + rank)
    do = torch.randn(o.larray.shape, device=dev, generator=gen).to(o.larray.dtype)
    comm.counts.clear()
    grads = torch.autograd.grad(o.larray, leaves, do, retain_graph=True)
    torch.cuda.synchronize()
    counts = dict(comm.counts)
    _every_rank_ok(comm, counts == {"collective-permute": WORLD} and fwd_launches == (rank + 1 if causal else WORLD)
                   and all(g.dtype == t.dtype and g.shape == t.shape and bool(torch.isfinite(g).all())
                           for g, t in zip(grads, leaves)),
                   f"ring_attention {name} backward: collectives, K9 launches, dtypes or values")
    sizes = comm.lshape_map(shape, 2)[:, 2]
    whole = [comm.allgather(t.detach(), 2, sizes) for t in leaves + [do]]
    gw = [comm.allgather(g, 2, sizes) for g in grads]
    err = torch.zeros(1, device=dev, dtype=torch.float64)
    if rank == 0:
        qw, kw, vw = (t.clone().requires_grad_() for t in whole[:3])
        ref = torch.autograd.grad(ka.flash_attention_plain(qw, kw, vw, causal)[0], (qw, kw, vw), whole[3])
        err[0] = max(float((g.double() - r.double()).abs().max() / r.double().abs().max()) for g, r in zip(gw, ref))
        del qw, kw, vw, ref
    err = comm.bcast(err, root=0)
    del whole, gw
    dt = str(q.larray.dtype).removeprefix("torch.")
    _require(float(err[0]) <= TOL_RING_GRAD[dt],
             f"ring_attention {name} backward disagrees with the plain version's autograd ({float(err[0]):.3e})")
    ms = _world_ms(lambda: torch.autograd.grad(o.larray, leaves, do, retain_graph=True), 3)
    for t in leaves:
        t.requires_grad_(False)
    return {"ms": ms, "err": float(err[0]), "tol": TOL_RING_GRAD[dt], "counts": counts, "forward_launches": fwd_launches}


DIST_N, DIST_D = 65536, 64  # X (and Y): 16384 rows a rank
DIST_SAMPLE = 64  # rows at each end of a rank's block held against float64
# timed calls of each world distance row after the counted one, whose own
# time stands where there are none: the direct forms (torch.cdist) take about
# 6 s a call
DIST_REPS = {"d": 0, "rbf": 0, "d2": 3}
# (name, the call given ring, the route measured, what is compared: distances, their squares, or rbf values)
WORLD_DISTANCE = (
    ("cdist_half_ring", lambda ht, X, Y, ring: ht.spatial.cdist(X, ring=ring), True, "d"),
    ("cdist_quadratic_ring", lambda ht, X, Y, ring: ht.spatial.cdist(X, Y, quadratic_expansion=True, ring=ring),
     True, "d2"),
    ("rbf_gather", lambda ht, X, Y, ring: ht.spatial.rbf(X, ring=ring), False, "rbf"),
)


def _max_abs_diff(a, b, squares: bool, chunk: int = 2048) -> float:
    """max |a - b| (of their squares with ``squares``), in row chunks: no
    temporary of a's size."""
    diffs = []
    for s in range(0, a.shape[0], chunk):
        x, y = a[s : s + chunk], b[s : s + chunk]
        diffs.append(float((x.square() - y.square() if squares else x - y).abs().max()))
    return max(diffs, default=0.0)


def _world_distance(ht, comm, moved: dict, rank: int, dev) -> dict:
    """The pairwise-distance ring on X = 65536 x 64 float32 split 0 (and Y of
    the same size): each rank's rows against a float64 reference on sampled
    rows and against the other route (ring against gather)."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(6000 + rank)
    rows = DIST_N // WORLD
    X = ht.array(torch.randn(rows, DIST_D, device=dev, generator=gen), is_split=0)
    Y = ht.array(torch.randn(rows, DIST_D, device=dev, generator=gen), is_split=0)
    out = {}
    for name, call, ring, kind in WORLD_DISTANCE:
        comm.counts.clear()
        moved.clear()
        comm.staged_bytes = 0
        kept = []
        ms = _world_ms(lambda: kept.append(call(ht, X, Y, ring)), 1)
        D = kept.pop()
        counts, nbytes, staged = dict(comm.counts), dict(moved), comm.staged_bytes
        shape_ok = D.split == 0 and D.gshape == (DIST_N, DIST_N) and D.lshape == (rows, DIST_N)
        other = Y if kind == "d2" else X
        whole = comm.allgather(other.larray).double()
        sample = torch.cat([X.larray[:DIST_SAMPLE], X.larray[-DIST_SAMPLE:]]).double()
        got = torch.cat([D.larray[:DIST_SAMPLE], D.larray[-DIST_SAMPLE:]]).double()
        ref = torch.cdist(sample, whole, compute_mode="donot_use_mm_for_euclid_dist")
        if kind == "d2":
            got, ref = got.square(), ref.square()
        elif kind == "rbf":
            ref = torch.exp(-ref.square() / 2.0)
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max()) / scale
        routed = call(ht, X, Y, not ring)
        err_route = _max_abs_diff(D.larray, routed.larray, kind == "d2") / scale
        del routed, whole
        _every_rank_ok(comm, shape_ok and err <= 1e-5 and err_route <= 1e-5,
                       f"{name}: split or shape, or against float64 ({err:.3e}) or the other route "
                       f"({err_route:.3e}), tol 1e-5 of the scale")
        del D
        torch.cuda.empty_cache()
        if DIST_REPS[kind]:
            ms = _world_ms(lambda: call(ht, X, Y, ring), DIST_REPS[kind])
        out[name] = {"counts": counts, "bytes": nbytes, "staged": staged, "err": err, "err_route": err_route,
                     "ms": ms}
        torch.cuda.empty_cache()
    return out


# the distributed sort family: (name, global length) of bench.py's sort_1gb
# row (bench.py:111, :1280) split 0 over the ranks; 2^27 gives B = 2^25 rows
# a rank (columnsort), 2^27 + 2 gives B = 2^25 + 1 (the odd-even network)
WORLD_SORTS = (("sort_1gb_split0", SORT_N), ("sort_1gb_ragged", SORT_N + 2))
WORLD_SORT_REPS = 2  # timed calls of each world sort row (1-3 s a call)
WORLD_UNIQUE_ROWS = (1 << 22, 4)  # unique(axis=0) of int32 in [0, 8), split 0


def _k4_steps(network: str, rank: int) -> int:
    """K4 launches of one distributed sort on this rank: the local sorts of
    the network's schedule."""
    if network == "columnsort":
        return 3 + (rank > 0) + (rank < WORLD - 1)
    rounds = 0
    for t in range(WORLD):
        pairs = [(a, a + 1) for a in range(t % 2, WORLD - 1, 2)]
        rounds += bool(pairs) and t % 2 <= rank <= pairs[-1][1]
    return 1 + rounds


def _same_sorted(a, b) -> bool:
    """Equal, NaN matching NaN."""
    import torch

    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _world_sort(ht, comm, moved: dict, rank: int, dev) -> dict:
    """``ht.sort``, ``ht.topk`` and ``ht.unique`` along the split axis over
    the ranks, each rank's shard from its own seed: both networks, each
    rank's K4 launches (one a local step of the schedule), and each rank's
    part of the results against ``torch.sort(stable=True)``/``torch.unique``
    of the gathered input on the card (indices bit for bit, values equal,
    NaN matching NaN)."""
    import torch

    from heat_tpu_torch.core import parallel
    from heat_tpu_torch.kernels import sort as ks

    gen = torch.Generator(device=dev)
    out = {}

    def counted(call):
        ks.SORT_LAUNCHES = 0
        comm.counts.clear()
        moved.clear()
        comm.staged_bytes = 0
        res = call()
        torch.cuda.synchronize()
        return res, {"launches": ks.SORT_LAUNCHES, "counts": dict(comm.counts), "bytes": dict(moved),
                     "staged": comm.staged_bytes}

    def mine(whole, n):  # this rank's chunk along dim 0 of a global result of length n
        return whole[comm.chunk((n,) + tuple(whole.shape[1:]), 0)[2]]

    for name, n in WORLD_SORTS:
        gen.manual_seed(7000 + rank)
        x = ht.array(torch.randn(comm.chunk((n,), 0)[1], device=dev, generator=gen), is_split=0)
        network = "columnsort" if parallel.columnsort_applicable(WORLD, -(-n // WORLD)) else "odd-even"
        (v, i), info = counted(lambda: ht.sort(x))
        whole = comm.allgather(x.larray, 0, comm.lshape_map((n,), 0)[:, 0])
        ref = torch.sort(whole, stable=True).indices
        want = _k4_steps(network, rank)
        _every_rank_ok(comm, torch.equal(i.larray, mine(ref, n)) and _same_sorted(v.larray, mine(whole[ref], n))
                       and info["launches"] == want and v.split == 0 and i.split == 0,
                       f"{name}: {network} sort against torch.sort(stable=True), or K4 launches "
                       f"{info['launches']} != {want} on rank {rank}")
        del v, i
        res = {**info, "network": network, "ms": _world_ms(lambda: ht.sort(x), WORLD_SORT_REPS)}
        steps = []
        ks.block_sort = _timed(ks.block_sort, steps)
        try:
            _world_ms(lambda: ht.sort(x), 1)
        finally:
            ks.block_sort = ks.block_sort.__wrapped__
        res["step_ms"] = [round(a.elapsed_time(b), 4) for a, b in steps]
        if name == "sort_1gb_split0":
            (vd, idd), res["descending"] = counted(lambda: ht.sort(x, descending=True))
            ok = torch.equal(idd.larray, mine(ref.flip(0), n))  # the flip of the ascending sort
            ok = ok and res["descending"]["launches"] == want
            del vd, idd
            (tv, ti), res["topk"] = counted(lambda: ht.topk(x, TOPK_K))
            top = torch.sort(whole, descending=True, stable=True).indices[:TOPK_K]  # the lower index first
            ok = ok and tv.split is None and torch.equal(ti.larray, top) and torch.equal(tv.larray, whole[top])
            ok = ok and res["topk"]["launches"] == 2  # the local top-k and the final selection
            u, res["unique"] = counted(lambda: ht.unique(x))
            distinct = torch.unique(whole)
            ok = ok and u.split == 0 and u.shape == distinct.shape and torch.equal(u.larray, mine(distinct,
                                                                                                 u.shape[0]))
            ok = ok and res["unique"]["launches"] == 2  # the local dedup and the merge of the candidates
            del u, distinct
            _every_rank_ok(comm, ok, f"{name}: descending, topk or unique against torch on the card, or K4 "
                                     f"launches (descending {want}, topk 2, unique 2) on rank {rank}")
            res["descending_ms"] = _world_ms(lambda: ht.sort(x, descending=True), WORLD_SORT_REPS)
            res["topk_ms"] = _world_ms(lambda: ht.topk(x, TOPK_K), WORLD_SORT_REPS)
            res["unique_ms"] = _world_ms(lambda: ht.unique(x), WORLD_SORT_REPS)
        out[name] = res
        del x, whole, ref
        torch.cuda.empty_cache()
    rows, width = WORLD_UNIQUE_ROWS
    gen.manual_seed(7100 + rank)
    X = ht.array(torch.randint(0, 8, (comm.chunk((rows, width), 0)[1][0], width), device=dev, generator=gen,
                               dtype=torch.int32), is_split=0)
    (u, inv), info = counted(lambda: ht.unique(X, return_inverse=True, axis=0))
    ru, rinv = torch.unique(comm.allgather(X.larray, 0, comm.lshape_map((rows, width), 0)[:, 0]), dim=0,
                            return_inverse=True)
    # K4 sorts each column once in the local dedup and once in the merge
    _every_rank_ok(comm, u.split == 0 and inv.split == 0 and info["launches"] == 2 * width and u.shape == ru.shape
                   and torch.equal(u.larray, mine(ru, ru.shape[0])) and torch.equal(inv.larray, mine(rinv, rows)),
                   f"unique(axis=0) against torch.unique on the card, or K4 launches {info['launches']} != "
                   f"{2 * width} on rank {rank}")
    out["unique_rows"] = {**info, "distinct": int(u.shape[0]),
                          "ms": _world_ms(lambda: ht.unique(X, return_inverse=True, axis=0), 3)}
    return out


# the surface phase of the world: one north-star operand (M x N float32)
# split across the ranks, and sort_1gb's 2^27 float32 split 0
WORLD_SURFACE_SEED = 9100


def _world_surface(ht, comm, moved: dict, rank: int, dev) -> dict:
    """The op machinery across ranks, each rank's operands made on the card
    from seeds every rank shares, so that each can regenerate the whole
    operand and check its own part: A (split 0) + B (split 1), one resplit
    of B; ``ht.cumsum(A, 0)`` along the split axis; ``A.mean(0)``,
    ``A.var(0)`` and ``A.argmax(axis=0)`` across ranks; ``ht.median`` of
    sort_1gb's 2^27 float32 split 0 (the distributed sort, K4 a local
    step)."""
    import torch

    from heat_tpu_torch.kernels import sort as ks

    gen = torch.Generator(device=dev)
    (r0, r1), (c0, c1) = [(comm.chunk((M, N), ax)[0], comm.chunk((M, N), ax)[0] + comm.chunk((M, N), ax)[1][ax])
                          for ax in (0, 1)]
    gen.manual_seed(WORLD_SURFACE_SEED)
    full_a = torch.randn(M, N, device=dev, generator=gen)
    gen.manual_seed(WORLD_SURFACE_SEED + 1)
    full_b = torch.randn(M, N, device=dev, generator=gen)
    A = ht.array(full_a[r0:r1].clone(), is_split=0)
    B = ht.array(full_b[:, c0:c1].clone(), is_split=1)
    out = {}

    def counted(call):
        ks.SORT_LAUNCHES = 0
        comm.counts.clear()
        moved.clear()
        comm.staged_bytes = 0
        res = call()
        torch.cuda.synchronize()
        return res, {"launches": ks.SORT_LAUNCHES, "counts": dict(comm.counts), "bytes": dict(moved),
                     "staged": comm.staged_bytes}

    S, info = counted(lambda: A + B)
    ok = S.split == 0 and torch.equal(S.larray, full_a[r0:r1] + full_b[r0:r1])
    _every_rank_ok(comm, ok, f"A (split 0) + B (split 1) differs from the torch sum on rank {rank}")
    del S
    out["add_split0_split1"] = {**info, "ms": _world_ms(lambda: A + B, 3)}
    del B, full_b

    C, info = counted(lambda: ht.cumsum(A, 0))
    head = full_a[:r0].double()
    ref = head.sum(0) + torch.cumsum(full_a[r0:r1].double(), 0)
    scale = head.abs().sum(0) + torch.cumsum(full_a[r0:r1].double().abs(), 0)
    err = float(((C.larray.double() - ref).abs() / scale).max()) if r1 > r0 else 0.0
    _every_rank_ok(comm, C.split == 0 and err <= 1e-5, f"cumsum along the split axis: {err:.3e} of the running "
                                                       f"sum of |x| on rank {rank} (tol 1e-5)")
    del C, head, ref, scale
    out["cumsum_split0"] = {**info, "err": err, "ms": _world_ms(lambda: ht.cumsum(A, 0), 3)}

    mean64 = torch.zeros(N, dtype=torch.float64, device=dev)
    var64 = torch.zeros(N, dtype=torch.float64, device=dev)
    for j in range(0, N, 1024):  # float64 in column blocks
        block = full_a[:, j: j + 1024].double()
        mean64[j: j + 1024] = block.mean(0)
        var64[j: j + 1024] = block.var(0, unbiased=False)
    first = torch.cat([_first_index_of_max(full_a[:, j: j + 1024], 0) for j in range(0, N, 1024)])
    for name, call, check in (
        ("mean_axis0", lambda: A.mean(axis=0),
         lambda o: float(((o.larray.double() - mean64).abs()).max()) / 1e-5),
        ("var_axis0", lambda: A.var(axis=0), lambda o: float(((o.larray.double() - var64).abs() / var64).max()) / 1e-5),
        ("argmax_axis0", lambda: A.argmax(axis=0), lambda o: 0.0 if torch.equal(o.larray, first) else 2.0),
    ):
        res, info = counted(call)
        err = check(res)
        _every_rank_ok(comm, res.split is None and err <= 1.0,
                       f"{name} across ranks: {err:.3f} of its limit on rank {rank}")
        out[name] = {**info, "err": err, "ms": _world_ms(call, 3)}
        del res
    del A, full_a, first, mean64, var64
    torch.cuda.empty_cache()

    gen.manual_seed(WORLD_SURFACE_SEED + 2)
    full_x = torch.randn(SORT_N, device=dev, generator=gen)
    x0, (cnt,), _ = comm.chunk((SORT_N,), 0)
    X = ht.array(full_x[x0: x0 + cnt].clone(), is_split=0)
    med, info = counted(lambda: ht.median(X))
    s = torch.sort(full_x).values
    pos = 0.5 * (SORT_N - 1)  # heat_tpu's split-axis formula: vlo + frac (vhi - vlo) in float32
    lo, hi = math.floor(pos), math.ceil(pos)
    want = s[lo] + torch.tensor(pos - lo, device=dev, dtype=torch.float32) * (s[hi] - s[lo])
    ok = med.split is None and torch.equal(med.larray.reshape(()), want) and info["launches"] > 0
    _every_rank_ok(comm, ok, f"median of the split sort_1gb against the sorted values, or no K4 launch "
                             f"({info['launches']}) on rank {rank}")
    out["median_sort_1gb"] = {**info, "ms": _world_ms(lambda: ht.median(X), 3)}
    del X, full_x, s, med
    torch.cuda.empty_cache()
    return out


WORLD_INDEXING_SEED = 9200
WORLD_INDEXING_ROWS = 1000  # rows of A[idx], drawn over the whole operand so that every rank owns some


def _world_indexing(ht, comm, moved: dict, rank: int, dev) -> dict:
    """Indexing across ranks on a 65536 x 8192 float32 operand split 0 (and
    its twin split 1), each rank's shard made on the card from a seed
    every rank shares: the mask selection ``A[A > 2.5]`` and
    ``ht.nonzero(A > 3.5)`` (even split-0 chunks), the gather ``A[idx]``
    of rows on every rank (whole on every rank), ``A[12345]`` (a row from
    its owner), ``Z[:, 5]`` of the split-1 twin, the mask assignment
    ``A[A < -4.0] = 0.0`` and ``repr(A)``; each rank checks its part
    against the whole operand."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(WORLD_INDEXING_SEED)
    full = torch.randn(M, N, device=dev, generator=gen)
    (r0, r1), (c0, c1) = [(comm.chunk((M, N), ax)[0], comm.chunk((M, N), ax)[0] + comm.chunk((M, N), ax)[1][ax])
                          for ax in (0, 1)]
    A = ht.array(full[r0:r1].clone(), is_split=0)
    out = {}

    def counted(call):
        comm.counts.clear()
        moved.clear()
        comm.staged_bytes = 0
        res = call()
        torch.cuda.synchronize()
        return res, {"counts": dict(comm.counts), "bytes": dict(moved), "staged": comm.staged_bytes}

    def chunk_of(whole):  # this rank's even split-0 chunk of a global result
        start, (count,), _ = comm.chunk((whole.shape[0],), 0)
        return whole[start: start + count]

    for name, call, want in (
        ("mask_elements", lambda: A[A > 2.5], lambda: torch.masked_select(full, full > 2.5)),
        ("nonzero", lambda: ht.nonzero(A > 3.5), lambda: torch.nonzero(full > 3.5)),
    ):
        res, info = counted(call)
        ref = want()
        ok = res.split == 0 and res.gshape[0] == ref.shape[0] and torch.equal(res.larray, chunk_of(ref))
        _every_rank_ok(comm, ok, f"{name} across ranks differs from the torch formula's chunk on rank {rank}")
        out[name] = {**info, "ms": _world_ms(call, 3), "selected": int(ref.shape[0])}
        del res, ref
    gen.manual_seed(WORLD_INDEXING_SEED + 1)
    rows = torch.randint(0, M, (WORLD_INDEXING_ROWS,), device=dev, generator=gen)
    idx = ht.array(rows)
    for name, call, want in (
        ("rows_every_rank", lambda: A[idx], lambda: full[rows]),
        ("row_from_owner", lambda: A[12345], lambda: full[12345]),
    ):
        res, info = counted(call)
        ok = res.split is None and torch.equal(res.larray, want())
        _every_rank_ok(comm, ok, f"{name} across ranks differs from the torch formula on rank {rank}")
        out[name] = {**info, "ms": _world_ms(call, 3)}
        del res
    ends = torch.tensor([sum(comm.chunk((M, N), 0, rank=q)[1][0] for q in range(r + 1)) for r in range(WORLD)],
                        device=dev)
    owners = torch.bincount(torch.searchsorted(ends, rows, right=True), minlength=WORLD)
    out["rows_every_rank"]["owned"] = owners.tolist()
    Z = ht.array(full[:, c0:c1].clone(), is_split=1)
    res, info = counted(lambda: Z[:, 5])
    _every_rank_ok(comm, res.split is None and torch.equal(res.larray, full[:, 5]),
                   f"Z[:, 5] of the split-1 operand differs on rank {rank}")
    out["column_split1"] = {**info, "ms": _world_ms(lambda: Z[:, 5], 3)}
    del Z, res

    def write():
        A[A < -4.0] = 0.0
    _, info = counted(write)
    expect = full[r0:r1].clone()
    expect[expect < -4.0] = 0.0
    _every_rank_ok(comm, torch.equal(A.larray, expect), f"A[A < -4.0] = 0.0 differs on rank {rank}")
    out["mask_assign"] = {**info, "ms": _world_ms(write, 3)}
    del expect
    text, info = counted(lambda: repr(A))
    whole = ht.array(torch.where(full < -4.0, torch.zeros((), device=dev), full))  # split None: no gather
    _every_rank_ok(comm, text == repr(whole).replace("split=None)", "split=0)"),
                   f"repr(A) across ranks differs from the whole operand's on rank {rank}")
    out["repr"] = {**info, "ms": _world_ms(lambda: repr(A), 3)}
    del A, whole, full
    torch.cuda.empty_cache()
    return out


def _report_world_indexing(per: list, shared: str) -> dict:
    """Print the indexing phase of the world; returns its collective counts."""
    what = {"mask_elements": "A[A > 2.5], A 65536x8192 float32 split 0 (even split-0 chunks)",
            "nonzero": "ht.nonzero(A > 3.5) (even split-0 chunks)",
            "rows_every_rank": f"A[idx], {WORLD_INDEXING_ROWS} random rows owned by every rank "
                               f"({per[0]['rows_every_rank']['owned']} a rank; whole on every rank)",
            "row_from_owner": "A[12345] (its owner broadcasts it)",
            "column_split1": "Z[:, 5], Z split 1 (its owner broadcasts it)",
            "mask_assign": "A[A < -4.0] = 0.0 (each rank in place)",
            "repr": "repr(A) (the edge items gathered)"}
    counts = {}
    for name, text in what.items():
        each = [p[name] for p in per]
        counts[name] = each[0]["counts"]
        print(
            f"world indexing {name}: {text}: {each[0]['ms']:.4f} ms a call (rank 0, median of 3; ranks "
            f"{[round(e['ms'], 4) for e in each]}); equal to the torch formula on every rank; collectives a rank "
            f"{each[0]['counts']}, bytes a rank put in {[e['bytes'] for e in each]}, staged through the host "
            f"{[e['staged'] for e in each]} B a rank; {shared}", flush=True,
        )
    return counts


def _world_worker(rank: int, init_file: str, out_dir: str) -> None:
    """One rank of the world phase: joins a gloo world of WORLD processes
    on ``cuda:0`` and runs every configuration; writes its results (or its
    traceback) to ``out_dir/rank<r>.json``."""
    import os
    import traceback

    import torch
    import torch.distributed as dist

    result = {"rank": rank}
    try:
        import heat_tpu_torch as ht
        from heat_tpu_torch.core.linalg import _cuda_sketch as cs
        from heat_tpu_torch.core.linalg import svdtools

        torch.cuda.set_device(0)
        ht.use_device(ht.gpu)
        ht.init_distributed(backend="gloo", init_method=f"file://{init_file}", world_size=WORLD, rank=rank)
        comm = ht.get_comm()
        moved, level0 = _count_bytes(comm), []
        _time_level0(svdtools, level0)
        for i, config in enumerate(WORLD_CONFIGS):
            result[config[0]] = _world_config(ht, cs, svdtools, comm, moved, level0, rank, config, profile=i == 0)
            torch.cuda.empty_cache()
        WORLD_REFERENCE.update(torch.load(os.path.join(out_dir, "reference.pt")))
        WORLD_DIR["dir"] = out_dir
        for phase, run in (("random", _world_random), ("kmeans", _world_kmeans), ("attention", _world_attention),
                           ("distance", _world_distance), ("sort", _world_sort), ("surface", _world_surface),
                           ("indexing", _world_indexing), ("train", _world_train), ("kmedians", _world_kmedians),
                           ("manip", _world_manip), ("linalg", _world_linalg), ("estimators", _world_estimators),
                           ("sparse", _world_sparse), ("io", _world_io), ("wire", _world_wire)):
            result[phase] = run(ht, comm, moved, rank, torch.device("cuda", 0))
            torch.cuda.empty_cache()
        dist.barrier()
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 (the parent fails the run with it)
        result["error"] = traceback.format_exc()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    if "error" in result:
        raise SystemExit(1)


def _report_world_sort(per: list, shared: str) -> dict:
    """Print the sort phase of the world from every rank's results; returns
    K4's launches a rank in each call."""
    launches = {}
    for name, n in WORLD_SORTS:
        each = [p[name] for p in per]
        launches[name] = [e["launches"] for e in each]
        nbytes = 2.0 * n * 8  # float32 values read and written, int64 indices written: 16 B an element
        print(
            f"world {name}: ht.sort(randn({n}) split 0), {each[0]['network']} at {-(-n // WORLD)} rows a rank: "
            f"{each[0]['ms']:.4f} ms a call (rank 0, median of {WORLD_SORT_REPS}; ranks {[round(e['ms'], 4) for e in each]}), bound "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms (the {WORLD} shards' float32 values read and written and their "
            f"int64 indices written, 16 B an element, {nbytes / 1e9:.4f} GB); K4 launches a rank {launches[name]} "
            f"(one a local step of the schedule); the local steps (block_sort, CUDA events on the rank's stream "
            f"in one more call, the other contexts sharing the card meanwhile) ms a rank "
            f"{[e['step_ms'] for e in each]}, summed {[round(sum(e['step_ms']), 4) for e in each]}; indices equal torch.sort(stable=True)'s bit for bit, values equal; collectives a rank "
            f"{each[0]['counts']}, bytes a rank put in {each[0]['bytes']}, staged through the host "
            f"{[e['staged'] for e in each]} B a rank; {shared}", flush=True,
        )
        if "descending" in each[0]:
            for key, what in (("descending", "ht.sort(x, descending=True) (the flip of the ascending sort)"),
                              ("topk", f"ht.topk(x, {TOPK_K}) (whole on every rank)"), ("unique", "ht.unique(x)")):
                print(
                    f"world {name}: {what}: {each[0][key + '_ms']:.4f} ms a call (rank 0, median of {WORLD_SORT_REPS}); K4 launches a "
                    f"rank {[e[key]['launches'] for e in each]}; equal to torch on the card; collectives a rank "
                    f"{each[0][key]['counts']}, bytes a rank put in {each[0][key]['bytes']}; {shared}", flush=True,
                )
    each = [p["unique_rows"] for p in per]
    launches["unique_rows"] = [e["launches"] for e in each]
    rows, width = WORLD_UNIQUE_ROWS
    print(
        f"world unique_rows: ht.unique(randint(0, 8, ({rows}, {width})) int32 split 0, return_inverse=True, axis=0): "
        f"{each[0]['ms']:.4f} ms a call (rank 0, median of 3), {each[0]['distinct']} distinct rows, equal to "
        f"torch.unique(dim=0) with its inverse; K4 launches a rank {launches['unique_rows']}; collectives a rank "
        f"{each[0]['counts']}, bytes a rank put in {each[0]['bytes']}; {shared}", flush=True,
    )
    return launches


def _report_world_surface(per: list, shared: str) -> dict:
    """Print the surface phase of the world; returns K4's launches a rank
    under the median."""
    gb = 4.0 * M * N
    bounds = {"add_split0_split1": 3 * gb, "cumsum_split0": 2 * gb, "mean_axis0": gb, "var_axis0": gb,
              "argmax_axis0": gb, "median_sort_1gb": 4.0 * SORT_N}
    what = {"add_split0_split1": f"A + B, A {M}x{N} split 0, B split 1 (B resplit to 0)",
            "cumsum_split0": "ht.cumsum(A, 0) along the split axis (1e-5 of the running sum of |x|)",
            "mean_axis0": "A.mean(axis=0) across ranks (|Δ| <= 1e-5 of float64)",
            "var_axis0": "A.var(axis=0) across ranks (rel 1e-5 of float64)",
            "argmax_axis0": "A.argmax(axis=0) across ranks (the first index of the maximum, exactly)",
            "median_sort_1gb": f"ht.median(x), x = randn({SORT_N}) split 0 (distributed sort; equal to the sorted "
                               f"values' interpolation)"}
    for name in bounds:
        each = [p[name] for p in per]
        print(
            f"world surface {name}: {what[name]}: {each[0]['ms']:.4f} ms a call (rank 0, median of 3; ranks "
            f"{[round(e['ms'], 4) for e in each]}), bound {bounds[name] / HBM_BYTES_PER_S * 1e3:.4f} ms (each "
            f"operand read once, the result written once: {bounds[name] / 1e9:.4f} GB); K4 launches a rank "
            f"{[e['launches'] for e in each]}; collectives a rank {each[0]['counts']}, bytes a rank put in "
            f"{each[0]['bytes']}, staged through the host {[e['staged'] for e in each]} B a rank; {shared}",
            flush=True,
        )
    return {"median_sort_1gb": [p["median_sort_1gb"]["launches"] for p in per]}


def world_path(dev) -> dict:
    """The north star as a WORLD-rank world on this one card: the parent
    has built every kernel; WORLD spawned workers join a gloo world
    (``init_method=file://``) with every rank's tensors on ``cuda:0`` and
    each run ``hsvd_rank`` on its per-chip shard (``WORLD_CONFIGS``). Four
    processes share one card and gloo moves the bytes through the host, so
    the times are the port's on one card, not a distributed timing.
    Returns each configuration's per-rank launches of its kernel."""
    import os
    import shutil
    import tempfile

    import torch
    import torch.multiprocessing as mp

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="heat_world_")
    torch.save(WORLD_REFERENCE, os.path.join(work, "reference.pt"))
    t0 = time.perf_counter()
    ctx = mp.start_processes(_world_worker, args=(os.path.join(work, "init"), work), nprocs=WORLD, join=False,
                             start_method="spawn")
    failure = None
    try:
        deadline = time.monotonic() + WORLD_TIMEOUT_S
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {WORLD}-rank world did not finish in {WORLD_TIMEOUT_S} s")
    except Exception as e:  # noqa: BLE001 (reported with the workers' tracebacks below)
        failure = e
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
        for proc in ctx.processes:
            proc.join(10)
    results = []
    for r in range(WORLD):
        path = os.path.join(work, f"rank{r}.json")
        results.append(json.load(open(path)) if os.path.exists(path) else {"error": "no result"})
    shutil.rmtree(work, ignore_errors=True)
    errors = [f"rank {r}: {res['error']}" for r, res in enumerate(results) if "error" in res]
    if failure is not None or errors:
        raise RuntimeError(f"chip_smoke: the {WORLD}-rank world failed: {failure}\n" + "\n".join(errors))
    print(f"world of {WORLD} ranks on one card (gloo, cuda:0 for every rank): {time.perf_counter() - t0:.1f} s "
          f"from the spawn", flush=True)
    launches = {}
    for name, shape, split, single_pass, rank8 in WORLD_CONFIGS:
        per = [res[name] for res in results]
        kernel = "dual_sketch_with_norm" if single_pass else "sketch_with_norm"
        launches[name] = [p["launches"][kernel] for p in per]
        passes = 1 if single_pass else 2
        bound = WORLD * passes * 4.0 * shape[0] * shape[1] / HBM_BYTES_PER_S * 1e3
        gshape = (WORLD * shape[0], shape[1]) if split == 0 else (shape[0], WORLD * shape[1])
        copy = (f", Sᵀ copy alone {[round(p['copy_ms'], 4) for p in per]} ms a rank"
                if per[0]["copy_ms"] is not None else "")
        print(
            f"world {name}: hsvd_rank({gshape[0]}x{gshape[1]} split {split}, {MAXRANK}, single_pass={single_pass}) "
            f"call {per[0]['call_ms']:.4f} ms (rank 0, median of {WORLD_REPS}; ranks "
            f"{[round(p['call_ms'], 4) for p in per]}), bound {bound:.4f} ms ({WORLD} x {passes} read(s) of a "
            f"{4 * shape[0] * shape[1] / 1e9:.4f} GB shard); level 0 a rank {[round(p['level0_ms'], 4) for p in per]} ms "
            f"in the call, {[round(p['level0_alone_ms'], 4) for p in per]} ms alone{copy}; launches of {kernel} a rank {launches[name]} (all on its Hopper kernel); collectives a rank "
            f"{per[0]['counts']}, bytes a rank put in {per[0]['bytes']}; orthonormality "
            f"{max(max(p['orthonormality']) for p in per):.2e} (tol 1e-4); sigma[0]={per[0]['sigma'][0]:.4f} "
            f"sigma[-1]={per[0]['sigma'][-1]:.4f} (equal on every rank)"
            + (f", sigma rel err {per[0]['sigma_rel_err']:.3e} (tol {RANK8_TOL[single_pass][0]})" if rank8 else "")
            + f", err={per[0]['err']:.6f}",
            flush=True,
        )
    shared = "four contexts share one card over gloo, not a distributed timing"
    per = [res["random"] for res in results]
    nbytes = 4.0 * WORLD_RANDOM[0] * WORLD_RANDOM[1]
    print(
        f"world random: ht.random.randn({WORLD_RANDOM[0]}, {WORLD_RANDOM[1]}, split=0): {per[0]['ms']:.4f} ms a "
        f"call (rank 0, median of 3; ranks {[round(p['ms'], 4) for p in per]}), bound (bytes) "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms (the {WORLD} chunks written once, {nbytes / 1e9:.2f} GB); R1 "
        f"launches a rank {[p['launches'] for p in per]} of {[p['elements'] for p in per]} elements (each rank its "
        f"chunk alone, rows from {[p['start'] for p in per]}), no collective; every rank's chunk equal to the plain "
        f"version at its ends; {shared}", flush=True,
    )
    print(
        f"world random: ht.random.randn({M}, {N}, split=1): {per[0]['split1']['ms']:.4f} ms a call (rank 0, median "
        f"of 3; ranks {[round(p['split1']['ms'], 4) for p in per]}); R1 launches a rank "
        f"{[p['split1']['launches'] for p in per]} of {[p['split1']['elements'] for p in per]} elements ({M} rows "
        f"of each rank's columns); every rank's chunk equal to the plain version at its ends; {shared}", flush=True,
    )
    per = [res["kmeans"] for res in results]
    km_bound = WORLD * 4.0 * KM_N * KM_D / HBM_BYTES_PER_S * 1e3
    print(
        f"world kmeans: KMeans({WORLD * KM_N}x{KM_D} split 0, k={KM_K}, kmeans++, {KM_ITERS} iterations).fit: "
        f"{per[0]['fit_ms']:.4f} ms (rank 0, median of 2), seeding {per[0]['seed_ms']:.4f} ms, Lloyd loop "
        f"{per[0]['loop_ms']:.4f} ms = {per[0]['loop_ms'] / KM_ITERS:.4f} ms an iteration (bound {km_bound:.4f} ms: one "
        f"read of the {WORLD} shards, {WORLD * 4.0 * KM_N * KM_D / 1e9:.1f} GB); K3 launches a rank "
        f"{[p['launches'] for p in per]} (= n_iter {KM_ITERS}); centers equal bit for bit on every rank; collectives "
        f"a rank in the fit {per[0]['counts']}, bytes a rank put in {per[0]['bytes']}; inertia {per[0]['inertia']:.6e}; "
        f"eight blobs recovered by kmeans++ (n_iter {per[0]['pp_iter']}) and from one point per blob (n_iter "
        f"{per[0]['blob_iter']}; against a plain Lloyd loop with the same all-reduce: centers rel "
        f"{per[0]['blob_err'][0]:.3e}, inertia rel {per[0]['blob_err'][1]:.3e}, tol {TOL_SUMS}); {shared}", flush=True,
    )
    world = {"hsvd": launches, "kmeans": [p["launches"] for p in per], "attention": {},
             "random": [res["random"]["launches"] for res in results],
             "random_split1": [res["random"]["split1"]["launches"] for res in results]}
    for name, shape, dt, causal in WORLD_ATTENTION:
        per = [res["attention"][name] for res in results]
        b, h, s, d = shape
        pairs = s * (s + 1) // 2 if causal else s * s
        flops = 4.0 * b * h * pairs * d
        peak = BF16_FLOP_PER_S if dt == "bfloat16" else TF32_FLOP_PER_S / 3
        world["attention"][name] = [p["launches"] for p in per]
        print(
            f"world ring_attention {name}: {shape} {dt} split 2, causal={causal}: {per[0]['ms']:.4f} ms a call "
            f"(rank 0, median of 3; ranks {[round(p['ms'], 4) for p in per]}), bound {flops / peak * 1e3:.4f} ms "
            f"({flops / 1e9:.1f} GFLOP at {peak / 1e12:.0f} TFLOP/s{'' if dt == 'bfloat16' else ' (3xTF32)'}); K9 "
            f"launches a rank {world['attention'][name]} (Hopper path {[p['sm90'] for p in per]}); against the plain "
            f"version on the whole q, k, v: max |Δo| {per[0]['abs_err']:.3e}, {per[0]['err']:.3f} of its limit "
            f"{_o_tol_text(getattr(torch, dt))}; collectives a rank {per[0]['counts']}, bytes a rank put "
            f"in {per[0]['bytes']}, staged through the host {[p['staged'] for p in per]} B a rank; {shared}",
            flush=True,
        )
        if "backward" in per[0]:
            bwd = [p["backward"] for p in per]
            world.setdefault("attention_backward", {})[name] = {
                "ms": [b["ms"] for b in bwd], "forward_ms": [p["ms"] for p in per], "err": bwd[0]["err"],
                "forward_launches": [b["forward_launches"] for b in bwd]}
            print(
                f"world ring_attention {name} backward (flash_attention_backward a _decompose call, plain torch; "
                f"the ring transposed): {bwd[0]['ms']:.4f} ms (rank 0, median of 3; ranks "
                f"{[round(b['ms'], 4) for b in bwd]}) beside the forward's {per[0]['ms']:.4f} ms; dQ, dK, dV against "
                f"the plain version's autograd on the whole q, k, v: max |Δ| / max |g| {bwd[0]['err']:.3e} (tol "
                f"{bwd[0]['tol']}); collectives a rank {bwd[0]['counts']}; K9 in its forward a rank "
                f"{[b['forward_launches'] for b in bwd]}; {shared}", flush=True,
            )
    for name, _, ring, kind in WORLD_DISTANCE:
        per = [res["distance"][name] for res in results]
        share = (WORLD // 2 + 1) / WORLD if name == "cdist_half_ring" else 1.0
        flops = (2.0 if kind == "d2" else 3.0) * share * DIST_N * DIST_N * DIST_D
        nbytes = 4.0 * DIST_N * DIST_N
        bound_ms, bound_by = _bound(nbytes, flops)
        print(
            f"world {name}: {DIST_N}x{DIST_N} from {DIST_N}x{DIST_D} float32 split 0, ring={ring}: {per[0]['ms']:.4f} ms "
            f"a call (rank 0, {f'median of {DIST_REPS[kind]}' if DIST_REPS[kind] else 'the counted call'}; ranks {[round(p['ms'], 4) for p in per]}), bound {bound_ms:.4f} ms "
            f"({bound_by}: {flops / 1e9:.1f} GFLOP at FP32's 67 TFLOP/s, the output's {nbytes / 1e9:.1f} GB); against "
            f"float64 on sampled rows {max(p['err'] for p in per):.3e}, against the other route "
            f"{max(p['err_route'] for p in per):.3e} of the scale (tol 1e-5); collectives a rank {per[0]['counts']}, "
            f"bytes a rank put in {per[0]['bytes']}, staged through the host {[p['staged'] for p in per]} B a rank; "
            f"{shared}", flush=True,
        )
    world["sort"] = _report_world_sort([res["sort"] for res in results], shared)
    world["surface"] = _report_world_surface([res["surface"] for res in results], shared)
    world["indexing"] = _report_world_indexing([res["indexing"] for res in results], shared)
    per = [res["train"] for res in results]
    flops, _ = _train_cost("cnn", TRAIN_BATCH)
    print(
        f"world train: the CNN on a global batch of {TRAIN_BATCH} split 0 ({TRAIN_BATCH // WORLD} rows a rank), "
        f"{WORLD_TRAIN_STEPS} SGD steps: parameters equal bit for bit on every rank, against world size 1 "
        f"{max(p['err'] for p in per):.3e} (tol {TOL_WORLD_TRAIN}); {per[0]['ms']:.4f} ms a step (rank 0, median of "
        f"3; ranks {[round(p['ms'], 4) for p in per]}), bound {flops / FP32_FLOP_PER_S * 1e3:.4f} ms (the step's "
        f"{flops / 1e12:.4f} TFLOP at FP32's 67 TFLOP/s on one card); collectives a rank in {WORLD_TRAIN_STEPS} steps "
        f"{per[0]['counts']}, bytes a rank put in {per[0]['bytes']}; DASO (2 nodes of 2, global_skip 2, bfloat16 "
        f"wire): equal within a node after step 1, all equal after the global sync of step 2; {per[0]['daso_ms']:.4f} "
        f"ms a step (median of 4, syncing every second), collectives a rank in those 4 steps {per[0]['daso_counts']}, "
        f"bytes {per[0]['daso_bytes']}; {shared}", flush=True,
    )
    world["train"] = [p["counts"] for p in per]
    world["kmedians"] = {}
    for est in ("KMedians", "KMedoids"):
        per = [res["kmedians"][est] for res in results]
        world["kmedians"][est] = [p["k4"] for p in per]
        print(
            f"world {est}: {KM_N}x{KM_D} split 0 over {WORLD} ranks (the world-size-1 draw), init random, "
            f"{per[0]['n_iter']} iterations: labels equal to world size 1's on every rank, centers rel "
            f"{max(p['err'] for p in per):.3e} (tol {TOL_KMD_CENTERS}); fit {per[0]['ms']:.4f} ms (rank 0, median "
            f"of 2; ranks {[round(p['ms'], 4) for p in per]}); K4 launches a rank {world['kmedians'][est]} (one an "
            f"iteration, {per[0]['k4_init']} under the init's permutation, as at world size 1); collectives a rank "
            f"in the fit {per[0]['counts']}, bytes a rank put in {per[0]['bytes']}; "
            f"{shared}", flush=True,
        )
    world["manip"] = _report_world_manip([res["manip"] for res in results], shared)
    world["linalg"] = _report_world_linalg([res["linalg"] for res in results], shared)
    world["estimators"] = _report_world_estimators([res["estimators"] for res in results], shared)
    world["sparse_rows"] = _report_world_sparse([res["sparse"] for res in results], shared)
    world["io"] = _report_world_io([res["io"] for res in results], shared)
    world["wire"] = _report_world_wire([res["wire"] for res in results], shared)
    return world


def timings(dev, launches: dict, errs: dict) -> list:
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.core.linalg import _cuda_sketch as cs

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    a = torch.randn(M, N, device=dev, generator=gen)
    g1 = torch.randn(25, M, device=dev, generator=gen)
    g2 = torch.randn(59, M, device=dev, generator=gen)
    omega = torch.randn(N, 24, device=dev, generator=gen)
    mn = float(M) * N
    rows = []
    # K1 on its Hopper kernel (sketch_sm90.cu, 3xTF32 on the tensor cores):
    # bound the read of A (the bytes), beside the 3xTF32 operation bound (N =
    # 32: L rounded up) and the FP32 CUDA-core bound that held sketch.cu's
    # kernel (pr1_ms: that kernel on the same inputs, timed in turns)
    _require(cs.sketch_sm90_serviceable(25, a), "K1's main shape is off its Hopper kernel")
    ms = _median_ms(lambda: cs.sketch_with_norm(g1, a), 10)
    pr1_ms = _median_ms(lambda: cs._sketch_with_norm_sketch_cu(g1, a), 10)
    ms_again = _median_ms(lambda: cs.sketch_with_norm(g1, a), 10)
    pr1_again = _median_ms(lambda: cs._sketch_with_norm_sketch_cu(g1, a), 10)
    plain_ms = _median_ms(lambda: cs.sketch_with_norm_plain(g1, a), 5)
    library_ms = _median_ms(lambda: torch.matmul(g1, a), 10)
    nbytes = 4 * (mn + 25 * M + 25 * N + 1)
    flops = 2 * 25 * mn + 2 * mn
    bound_ms, bound_by = _bound(nbytes, flops)
    tf32_ms = 3 * 2 * 32 * mn / TF32_FLOP_PER_S * 1e3
    fp32_ms = flops / FP32_FLOP_PER_S * 1e3
    print(
        f"sketch_with_norm (K1 sketch_sm90.cu): {ms:.4f} ms [{ms_again:.4f}], sketch.cu's kernel (pr1_ms) "
        f"{pr1_ms:.4f} ms [{pr1_again:.4f}], plain {plain_ms:.4f} ms, library (g @ a, w only) {library_ms:.4f} ms; "
        f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e9:.4f} GB), 3xTF32 operations at N = 32 {tf32_ms:.4f} ms, "
        f"FP32 CUDA cores {fp32_ms:.4f} ms; {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s achieved, "
        f"{bound_ms / ms:.1%} of the bound", flush=True,
    )
    rows.append({
        "name": "sketch_with_norm", "route": "cuda", "source": "heat_tpu_torch/csrc/sketch_sm90.cu",
        "replaces": "heat_tpu/core/linalg/_pallas_sketch.py:56", "launches": launches["sketch_with_norm"],
        "max_abs_err": errs["sketch_with_norm"], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms, "pr1_ms": pr1_ms, "pr1_err": errs["sketch_with_norm_pr1"],
        "bound_3xtf32_ms": tf32_ms, "bound_fp32_ms": fp32_ms,
        "world_launches": {k: v for k, v in launches["world"]["hsvd"].items() if "one_view" not in k},
    })
    # K2 on its Hopper kernel (sketch_sm90.cu, 3xTF32 on the tensor cores):
    # bound the read of A (the bytes), beside the 3xTF32 operation bound and
    # the FP32 CUDA-core bound that held sketch.cu's kernel (pr1_ms: that
    # kernel on the same inputs); composed_ms: g @ a, a @ omega and
    # a.square().sum() back to back, context only (three reads of A)
    _require(cs.dual_sketch_sm90_serviceable(59, 24, a), "K2's main shape is off its Hopper kernel")
    flops = 2 * (59 + 24) * mn + 2 * mn
    nbytes = 4 * (mn + 59 * M + 24 * N + 59 * N + 24 * M + 1)
    ms = _median_ms(lambda: cs.dual_sketch_with_norm(g2, omega, a), 10)
    pr1_ms = _median_ms(lambda: cs._dual_sketch_with_norm_sketch_cu(g2, omega, a), 10)
    ms_again = _median_ms(lambda: cs.dual_sketch_with_norm(g2, omega, a), 10)
    pr1_again = _median_ms(lambda: cs._dual_sketch_with_norm_sketch_cu(g2, omega, a), 10)
    plain_ms = _median_ms(lambda: cs.dual_sketch_with_norm_plain(g2, omega, a), 5)
    composed_ms = _median_ms(lambda: (torch.matmul(g2, a), torch.matmul(a, omega), a.square().sum()), 10)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    tf32_ms = 3 * flops / TF32_FLOP_PER_S * 1e3
    fp32_ms = flops / FP32_FLOP_PER_S * 1e3
    print(
        f"dual_sketch_with_norm (K2 sketch_sm90.cu): {ms:.4f} ms [{ms_again:.4f}], sketch.cu's kernel (pr1_ms) "
        f"{pr1_ms:.4f} ms [{pr1_again:.4f}], plain {plain_ms:.4f} ms, composed (g @ a, a @ omega, a.square().sum()) "
        f"{composed_ms:.4f} ms; bound {bound_ms:.4f} ms (bytes: {nbytes / 1e9:.4f} GB), 3xTF32 operations "
        f"{tf32_ms:.4f} ms, FP32 CUDA cores {fp32_ms:.4f} ms; {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s achieved, "
        f"{bound_ms / ms:.1%} of the bound", flush=True,
    )
    rows.append({
        "name": "dual_sketch_with_norm", "route": "cuda", "source": "heat_tpu_torch/csrc/sketch_sm90.cu",
        "replaces": "heat_tpu/core/linalg/_pallas_sketch.py:105", "launches": launches["dual_sketch_with_norm"],
        "max_abs_err": errs["dual_sketch_with_norm"], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": None, "pr1_ms": pr1_ms, "pr1_err": errs["dual_sketch_with_norm_pr1"],
        "composed_ms": composed_ms, "bound_3xtf32_ms": tf32_ms, "bound_fp32_ms": fp32_ms,
        "world_launches": {k: v for k, v in launches["world"]["hsvd"].items() if "one_view" in k},
    })
    A = ht.array(a, split=0)
    for single_pass, passes in ((False, 2), (True, 1)):
        t0 = time.perf_counter()
        ms = _median_ms(lambda: ht.linalg.hsvd_rank(A, MAXRANK, compute_sv=True, single_pass=single_pass), 5)
        print(
            f"hsvd_rank(single_pass={single_pass}): {ms:.4f} ms (median of 5, CUDA events), "
            f"bound {passes * 4 * mn / HBM_BYTES_PER_S * 1e3:.4f} ms ({passes} read(s) of A); "
            f"{(time.perf_counter() - t0) / 6 * 1e3:.1f} ms host time per call with its sync", flush=True,
        )
    for single_pass in (False, True):
        profile_breakdown(
            f"hsvd_rank(single_pass={single_pass})",
            lambda: ht.linalg.hsvd_rank(A, MAXRANK, compute_sv=True, single_pass=single_pass),
        )
    return rows


def kmeans_timings(dev, launches: int, err: float) -> dict:
    """K3, its plain version and the one library product at the main
    shape, then the KMeans fit: per Lloyd iteration, its seeding and its
    final assignment, and a profile of one fit. Returns K3's row."""
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.cluster import _cuda_assign as ca
    from heat_tpu_torch.cluster._kcluster import _kmeanspp, _predict, _seed_key, make_fit_loop
    from heat_tpu_torch.cluster.kmeans import _lloyd_step

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    x = torch.randn(KM_N, KM_D, device=dev, generator=gen)
    c = x[torch.randperm(KM_N, device=dev, generator=gen)[:KM_K]].contiguous()
    ms = _median_ms(lambda: ca.fused_assign(x, c), 10)
    plain_ms = _median_ms(lambda: ca.fused_assign_plain(x, c), 5)
    library_ms = _median_ms(lambda: torch.matmul(x, c.T), 10)
    n, d, k = float(KM_N), KM_D, KM_K
    nbytes = 4 * (n * d + k * d + k * d + k + 1)
    flops = 2 * n * k * d + 2 * n * k * (d + 2)
    bound_ms, bound_by = _bound(nbytes, flops)
    print(
        f"fused_assign: {ms:.4f} ms, plain {plain_ms:.4f} ms, library (x @ c.T) {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})", flush=True,
    )
    row = {
        "name": "fused_assign", "route": "cuda", "source": "heat_tpu_torch/csrc/kmeans_assign.cu",
        "replaces": "heat_tpu/cluster/_pallas.py:66", "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }

    X = ht.array(x, split=0)

    def fit():
        return ht.cluster.KMeans(
            n_clusters=KM_K, init="kmeans++", max_iter=KM_ITERS, tol=-1.0, random_state=0
        ).fit(X)

    fit_ms = _median_ms(fit, 3)
    seed_ms = _median_ms(lambda: _kmeanspp(x, KM_K, _seed_key(KM_K)), 3)
    loop = make_fit_loop(_lloyd_step, -1.0, KM_ITERS, True)
    loop_ms = _median_ms(lambda: loop(x, c), 3)
    final_ms = _median_ms(lambda: _predict(x, c, "euclidean", True), 3)
    per_iter = loop_ms / KM_ITERS
    print(
        f"KMeans.fit({KM_N}x{KM_D}, k={KM_K}, kmeans++, {KM_ITERS} iterations): {fit_ms:.4f} ms "
        f"(median of 3, CUDA events); Lloyd loop {loop_ms:.4f} ms = {per_iter:.4f} ms per iteration, "
        f"{1e3 / per_iter:.2f} iterations per second (bound {row['bound_ms']:.4f} ms per iteration, one "
        f"read of X); seeding {seed_ms:.4f} ms; final assignment {final_ms:.4f} ms", flush=True,
    )
    profile_breakdown(f"KMeans.fit({KM_ITERS} iterations)", fit)
    return row


# --------------------------------------------------------------------- #
# the sparse engine and PageRank (kernels K7 and K8)                    #
# --------------------------------------------------------------------- #
def sparse_inputs() -> dict:
    """The host inputs of the sparse rows, built as bench.py builds them
    (seed 0x18): spmm_1gb's BSR and pagerank_2m's adjacency."""
    import numpy as np
    import scipy.sparse as sp

    t0 = time.perf_counter()
    rng = np.random.default_rng(SPARSE_SEED)
    smb, snb = SPMM_N // 8, SPMM_N // 128
    lin = np.sort(rng.choice(smb * snb, int(smb * snb * SPMM_OCC), replace=False))
    brow = (lin // snb).astype(np.int32)
    indptr = np.zeros(smb + 1, np.int64)
    np.add.at(indptr, brow + 1, 1)
    bsr = sp.bsr_matrix(
        (rng.standard_normal((lin.size, 8, 128)).astype(np.float32), (lin % snb).astype(np.int32), np.cumsum(indptr)),
        shape=(SPMM_N, SPMM_N),
    )
    prng = np.random.default_rng(SPARSE_SEED)
    src, dst = prng.integers(0, PR_N, PR_N * PR_DEG), prng.integers(0, PR_N, PR_N * PR_DEG)
    keep = src != dst
    graph = sp.csr_matrix((np.ones(int(keep.sum()), np.float32), (src[keep], dst[keep])), shape=(PR_N, PR_N))
    graph.sum_duplicates()
    print(
        f"sparse inputs on the host: spmm_1gb {SPMM_N}^2 with {lin.size} bricks ({bsr.nnz} nnz), pagerank_2m "
        f"{PR_N} nodes with {graph.nnz} edges, {time.perf_counter() - t0:.1f} s", flush=True,
    )
    return {"bsr": bsr, "graph": graph}


def card_matrix(dev, ht):
    """The card-scale brick matrix, built on the card from a seeded
    generator and passed to the raw constructor: 131072^2, 1,048,576
    distinct bricks (6.25% of the brick grid, 64 per brick row on average,
    bcol ascending within each row), randn data."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(SPARSE_SEED)
    mb, nb = CARD_N // 8, CARD_N // 128
    lin = torch.sort(torch.randperm(mb * nb, device=dev, generator=gen)[:CARD_BRICKS]).values
    brow, bcol = (lin // nb).to(torch.int32), (lin % nb).to(torch.int32)
    bdata = torch.randn(CARD_BRICKS, 8, 128, device=dev, generator=gen)
    bmask = torch.ones(CARD_BRICKS, 8, dtype=torch.bool, device=dev)
    gnnz = int(torch.count_nonzero(bdata))
    return ht.sparse.DBCSR_matrix(bdata, bcol, brow, bmask, ((0, mb, CARD_BRICKS),), gnnz, CARD_BRICKS,
                                  (CARD_N, CARD_N), ht.float32, 0, ht.gpu, ht.get_comm())


def _k7_case(ks, label: str, S, k: int, gen) -> float:
    """K7 against its plain version on S's bricks (widened to float32),
    within TOL_SPARSE of the absolute-sum scale, and against itself on a
    rerun, bit for bit. Returns the largest absolute error."""
    import torch

    bdata, bcol, brow, bmask = S._phys_components
    bd = bdata.float()
    m = S.shape[0]
    x = torch.randn(S.shape[1], k, device=bd.device, generator=gen)
    y = ks.brick_spmm(bd, bcol, brow, bmask, S._brick_rowptr, x, m)
    again = ks.brick_spmm(bd, bcol, brow, bmask, S._brick_rowptr, x, m)
    ref = ks.brick_spmm_plain(bd, bcol, brow, bmask, x, m)
    scale = ks.brick_spmm_plain(bd.abs(), bcol, brow, bmask, x.abs(), m)
    torch.cuda.synchronize()
    err = float((y - ref).abs().max()) if y.numel() else 0.0
    rel = float(((y - ref).abs() / scale.clamp_min(1e-30)).max()) if y.numel() else 0.0
    rerun = torch.equal(y, again)
    print(f"K7 ({label}, k={k}): max |err| {err:.3e}, max err/scale {rel:.3e} (tol {TOL_SPARSE}), rerun identical {rerun}",
          flush=True)
    _require(bool(((y - ref).abs() <= TOL_SPARSE * scale).all()) and rerun,
             f"K7 disagrees with its plain version or itself ({label}, k={k})")
    return err


def _k8_case(ks, label: str, S, d: int, gen) -> tuple:
    """K8 against its plain version, within TOL_SPARSE of the scale
    |s|·(|u|·|v|ᵀ), and on a rerun bit for bit, on the kernel its predicate
    picks (its Hopper launch count must show which); on the Hopper kernel
    spmm.cu's kernel runs on the same inputs too, held to the plain version
    under the same limit. Returns the largest absolute errors of the route's
    kernel and of spmm.cu's (None off the Hopper kernel)."""
    import torch

    sdata, bcol, brow, _ = S._phys_components
    sd = sdata.float()
    u = torch.randn(S.shape[0], d, device=sd.device, generator=gen)
    v = torch.randn(S.shape[1], d, device=sd.device, generator=gen)
    hopper = ks.sddmm_sm90_serviceable(d, S.shape[0], (u.data_ptr(), v.data_ptr(), sd.data_ptr()))
    before = ks.SDDMM_SM90_LAUNCHES
    out = ks.brick_sddmm(sd, brow, bcol, *S._brick_colorder, u, v)
    again = ks.brick_sddmm(sd, brow, bcol, *S._brick_colorder, u, v)
    _require(ks.SDDMM_SM90_LAUNCHES == before + 2 * int(hopper),
             f"K8 ({label}, d={d}) {'did not take' if hopper else 'took'} the Hopper kernel")
    ref = ks.brick_sddmm_plain(sd, brow, bcol, u, v)
    scale = ks.brick_sddmm_plain(sd.abs(), brow, bcol, u.abs(), v.abs())
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    rel = float(((out - ref).abs() / scale.clamp_min(1e-30)).max())
    rerun = torch.equal(out, again)
    ok_old, old, old_err = True, "", None
    if hopper:
        del again
        again = ks._brick_sddmm_spmm_cu(sd, brow, bcol, *S._brick_colorder, u, v)
        torch.cuda.synchronize()
        old_err = float((again - ref).abs().max())
        old_rel = float(((again - ref).abs() / scale.clamp_min(1e-30)).max())
        ok_old = old_rel <= TOL_SPARSE
        old = f"; spmm.cu's kernel: max |err| {old_err:.3e}, max err/scale {old_rel:.3e}"
    print(f"K8 {'sddmm_sm90' if hopper else 'spmm'} ({label}, d={d}): max |err| {err:.3e}, max err/scale {rel:.3e} "
          f"(tol {TOL_SPARSE}), rerun identical {rerun}{old}", flush=True)
    _require(bool(((out - ref).abs() <= TOL_SPARSE * scale).all()) and rerun and ok_old,
             f"K8 disagrees with its plain version or itself ({label}, d={d})")
    del out, again, ref, scale
    return err, old_err


def check_spmm(dev, inputs: dict) -> dict:
    """K7 and K8 against their plain versions at the main-path shapes and
    at ragged, empty-row, zero-brick, empty and bf16 ones; returns the
    largest error at each main-path shape."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.graph.pagerank import _transition
    from heat_tpu_torch.kernels import spmm as ks

    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    errs = {}
    S = ht.sparse.sparse_dbcsr_matrix(inputs["bsr"], split=0)
    for k in (1, SPMM_K, 64):
        errs[f"spmm_1gb_k{k}"] = _k7_case(ks, f"spmm_1gb, {S.nbricks} bricks", S, k, gen)
    for d in (1, SDDMM_D):
        errs[f"sddmm_1gb_d{d}"] = _k8_case(ks, f"spmm_1gb, {S.nbricks} bricks", S, d, gen)
    M = ht.sparse.sparse_dbcsr_matrix(_transition(inputs["graph"], np.float32)[0], split=0)
    errs["pagerank_k1"] = _k7_case(ks, f"pagerank_2m transition, {M.nbricks} bricks", M, 1, gen)
    del S, M

    C = card_matrix(dev, ht)
    for k in (1, SPMM_K):
        errs[f"card_k{k}"] = _k7_case(ks, f"{CARD_N}^2, {CARD_BRICKS} bricks", C, k, gen)
    errs[f"card_sddmm_d{SDDMM_D}"] = _k8_case(ks, f"{CARD_N}^2, {CARD_BRICKS} bricks", C, SDDMM_D, gen)
    del C
    torch.cuda.empty_cache()

    rng = np.random.default_rng(11)
    ragged = sp.random(1003, 777, density=0.02, format="csr", dtype=np.float32, random_state=rng)
    R = ht.sparse.sparse_dbcsr_matrix(ragged)
    # every third brick row holds bricks, the rest are empty rows
    dense = np.zeros((4096, 4096), np.float32)
    dense[::24] = rng.standard_normal((len(range(0, 4096, 24)), 4096)) * (rng.random((171, 4096)) < 0.05)
    E = ht.sparse.sparse_dbcsr_matrix(sp.csr_matrix(dense))
    # stored bricks of all zeros, and pad bricks after the real ones
    bdata, bcol, brow, bmask = R._phys_components
    zero = bdata.clone()
    zero[::3] = 0
    pads = 5
    Z = ht.sparse.DBCSR_matrix(
        torch.cat([zero, torch.zeros(pads, 8, 128, device=dev)]), torch.cat([bcol, bcol[:pads] * 0]),
        torch.cat([brow, brow[:pads] * 0]), torch.cat([bmask, torch.zeros(pads, 8, dtype=torch.bool, device=dev)]),
        ((0, R.mb, R.nbricks),), R.gnnz, R.nbricks, R.shape, ht.float32, None, ht.gpu, ht.get_comm(),
    )
    empty = ht.sparse.sparse_dbcsr_matrix(sp.csr_matrix((37, 300), dtype=np.float32))
    _require(empty.slab_bricks == 1 and empty.nbricks == 0, "the empty matrix is not one pad brick")
    half = R.astype(ht.bfloat16)
    # rows that bmask clears (every 7th brick's row 3, and the rows past m)
    # hold NaN: they must add nothing
    bdata, bcol, brow, bmask = R._phys_components
    bmask = bmask.clone()
    bmask[::7, 3] = False
    masked = torch.where(bmask[:, :, None], bdata, float("nan"))
    Q = ht.sparse.DBCSR_matrix(masked, bcol, brow, bmask, ((0, R.mb, R.nbricks),), R.gnnz, R.nbricks, R.shape,
                               ht.float32, None, ht.gpu, ht.get_comm())
    for label, A in (("ragged 1003x777", R), ("4096^2 with empty rows", E), ("zero and pad bricks", Z),
                     ("empty 37x300, one pad brick", empty), ("bf16 bricks, 1003x777", half),
                     ("masked rows holding NaN, 1003x777", Q)):
        for k in (1, SPMM_K, 64):
            _k7_case(ks, label, A, k, gen)
        if A is not Q:  # K8 scales every row of a brick, masked or not
            for d in (1, SDDMM_D) + K8_EDGE_D:
                _k8_case(ks, label, A, d, gen)
    return errs


def _scale_check(label: str, got, ref, scale, tol: float) -> float:
    """|got - ref| <= tol * scale elementwise (float64); returns the
    largest err/scale."""
    import numpy as np

    got, ref, scale = (np.asarray(a, dtype=np.float64) for a in (got, ref, scale))
    _require(got.shape == ref.shape, f"{label}: shape {got.shape}, expected {ref.shape}")
    _require(bool(np.isfinite(got).all()), f"{label}: non-finite values")
    rel = float(np.max(np.abs(got - ref) / np.maximum(scale, 1e-30))) if got.size else 0.0
    print(f"{label}: max err/scale against the float64 reference {rel:.3e} (tol {tol})", flush=True)
    _require(rel <= tol, f"{label} disagrees with its float64 reference")
    return rel


def _pagerank_reference(graph, alpha=0.85, tol=1e-13, max_iter=1000):
    """float64 power iteration with scipy, uniform dangling teleport."""
    import numpy as np
    import scipy.sparse as sp

    n = graph.shape[0]
    outdeg = np.asarray(graph.sum(axis=1)).ravel().astype(np.float64)
    dangling = outdeg == 0
    M = (sp.diags(np.where(dangling, 0.0, 1.0 / np.maximum(outdeg, 1.0))) @ graph.astype(np.float64)).T.tocsr()
    r = np.full(n, 1.0 / n)
    for _ in range(max_iter):
        r_new = alpha * (M @ r + r[dangling].sum() / n) + (1 - alpha) / n
        done = np.abs(r_new - r).sum() < tol
        r = r_new
        if done:
            break
    return r / r.sum()


def sparse_path(dev, inputs: dict) -> dict:
    """The sparse main path through the public entry points, each call
    with the kernel counts set to 0 just before it and read just after;
    returns the launches of each call."""
    import numpy as np
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.kernels import spmm as ks

    def run(label: str, call):
        ks.SPMM_LAUNCHES = ks.SDDMM_LAUNCHES = ks.SDDMM_SM90_LAUNCHES = 0
        out = call()
        torch.cuda.synchronize()
        counts = (ks.SPMM_LAUNCHES, ks.SDDMM_LAUNCHES)
        print(f"{label}: K7 launches {counts[0]}, K8 launches {counts[1]} (on its Hopper kernel "
              f"{ks.SDDMM_SM90_LAUNCHES})", flush=True)
        _require(ks.SDDMM_SM90_LAUNCHES == counts[1], f"{label}: K8 ran off its Hopper kernel")
        return out, counts

    launches = {}
    rng = np.random.default_rng(12)
    bsr = inputs["bsr"]
    t0 = time.perf_counter()
    S = ht.sparse.sparse_dbcsr_matrix(bsr, split=0)
    print(f"spmm_1gb: sparse_dbcsr_matrix {time.perf_counter() - t0:.2f} s, {S}", flush=True)
    _require(S.nbricks == int((SPMM_N // 8) * (SPMM_N // 128) * SPMM_OCC) and S._phys_components[0].device == dev, "spmm_1gb matrix geometry or device")
    x = rng.standard_normal((SPMM_N, SPMM_K)).astype(np.float32)
    y, counts = run(f"spmm_1gb: S @ x, x ({SPMM_N}, {SPMM_K})", lambda: S @ x)
    launches["spmm_1gb"] = counts[0]
    _require(counts == (1, 0) and y.split == 0 and y.larray.device == dev, "S @ x did not run K7 once")
    absA = abs(bsr).astype(np.float64)
    _scale_check("spmm_1gb S @ x vs scipy", y.numpy(), bsr.astype(np.float64) @ x.astype(np.float64),
                 absA @ np.abs(x).astype(np.float64), TOL_SPARSE)
    D = ht.sparse.sparse_csr_matrix(bsr, split=0)
    yd, counts = run("spmm_1gb: DCSR @ x (index_add_)", lambda: D @ x)
    _require(counts == (0, 0), "the DCSR form ran a brick kernel")
    _scale_check("spmm_1gb DCSR @ x vs scipy", yd.numpy(), bsr.astype(np.float64) @ x.astype(np.float64),
                 absA @ np.abs(x).astype(np.float64), TOL_SPARSE)
    del D, yd
    u = torch.from_numpy(rng.standard_normal((SPMM_N, SDDMM_D)).astype(np.float32)).to(dev)
    v = torch.from_numpy(rng.standard_normal((SPMM_N, SDDMM_D)).astype(np.float32)).to(dev)
    C, counts = run(f"spmm_1gb: sddmm(S, u, v), d={SDDMM_D}", lambda: ht.sparse.sddmm(S, u, v))
    launches["sddmm_1gb"] = counts[1]
    _require(counts == (0, 1) and C.nbricks == S.nbricks, "sddmm did not run K8 once")
    sdata, bcol, brow, _ = S._phys_components
    ref = ks.brick_sddmm_plain(sdata.double(), brow, bcol, u.double(), v.double())
    scale = ks.brick_sddmm_plain(sdata.double().abs(), brow, bcol, u.double().abs(), v.double().abs())
    _scale_check("spmm_1gb sddmm vs float64 (plain version in float64 on the card)",
                 C._phys_components[0].cpu().numpy(), ref.cpu().numpy(), scale.cpu().numpy(), TOL_SPARSE)
    del S, C, ref, scale, u, v

    Cm = card_matrix(dev, ht)
    bdata, bcol, brow, bmask = Cm._phys_components
    for k in (1, SPMM_K):
        xk = torch.randn(CARD_N, k, device=dev)
        y, counts = run(f"{CARD_N}^2 ({CARD_BRICKS} bricks): S @ x, k={k}", lambda: Cm @ xk)
        launches[f"card_k{k}"] = counts[0]
        _require(counts == (1, 0) and y.shape == (CARD_N, k), f"S @ x (k={k}) did not run K7 once")
        ref = ks.brick_spmm_plain(bdata.double(), bcol, brow, bmask, xk.double(), CARD_N)
        scale = ks.brick_spmm_plain(bdata.double().abs(), bcol, brow, bmask, xk.double().abs(), CARD_N)
        _scale_check(f"{CARD_N}^2 S @ x (k={k}) vs float64 (plain version on the card)", y.numpy(), ref.cpu().numpy(),
                     scale.cpu().numpy(), TOL_SPARSE)
        del y, ref, scale
    u, v = torch.randn(CARD_N, SDDMM_D, device=dev), torch.randn(CARD_N, SDDMM_D, device=dev)
    Cs, counts = run(f"{CARD_N}^2: sddmm(S, u, v), d={SDDMM_D}", lambda: ht.sparse.sddmm(Cm, u, v))
    launches[f"card_sddmm_d{SDDMM_D}"] = counts[1]
    _require(counts == (0, 1), "sddmm did not run K8 once")
    out = Cs._phys_components[0]
    _require(out.shape == bdata.shape and bool(torch.isfinite(out).all()), "sddmm output shape or values")
    del Cs, out, Cm, bdata, bcol, brow, bmask
    torch.cuda.empty_cache()

    graph = inputs["graph"]
    res, counts = run(f"pagerank_2m: ht.graph.pagerank({PR_N} nodes, {graph.nnz} edges, tol={PR_TOL})",
                      lambda: ht.graph.pagerank(graph, tol=PR_TOL))
    launches["pagerank"] = counts[0]
    ranks = res.ranks.numpy()
    ref = _pagerank_reference(graph)
    err = float(np.abs(ranks - ref).max())
    print(
        f"pagerank_2m: {res.iterations} iterations (heat_tpu on the CPU: {PR_HEAT_TPU_ITERATIONS}), converged "
        f"{res.converged}, delta {res.delta:.3e}; ranks vs float64 scipy power iteration max |err| {err:.3e} "
        f"(tol {TOL_RANKS}), max rel err {float(np.abs(ranks - ref).max() / ref.max()):.3e}", flush=True,
    )
    _require(res.converged and counts == (res.iterations, 0), "PageRank did not run K7 once per iteration")
    _require(err <= TOL_RANKS and abs(float(ranks.sum()) - 1.0) <= 1e-5, "PageRank ranks off")
    launches["pagerank_iterations"] = res.iterations
    return launches


def _csr_of(S, device, with_slots: bool = False):
    """The CSR tensor (int32 indices) of the nonzeros of this rank's slab of
    the brick matrix ``S`` (every brick row of the slab, (g1 - g0)·8 rows:
    the whole matrix at world size 1), built on the card, and
    (``with_slots``) the flat brick slot of each of its entries (int32),
    else None."""
    import torch

    bdata, bcol, brow, _ = S._phys_components
    nreal = S._nreal
    g0, g1 = S._slab_rows
    rowptr = S._brick_rowptr
    m, n = (g1 - g0) * 8, S.nb * 128
    _require(S.shape[1] == n and (S.is_distributed() or S.shape[0] == m), "the library yardstick takes whole bricks")
    per_row = (rowptr[1:] - rowptr[:-1]).long()
    start = rowptr[:-1].long()
    crow = torch.empty(m + 1, dtype=torch.int64, device=device)
    crow[:-1] = (1024 * start[:, None] + 128 * per_row[:, None] * torch.arange(8, device=device)).reshape(-1)
    crow[-1] = 1024 * nreal
    values = torch.empty(1024 * nreal, dtype=bdata.dtype, device=device)
    cols = torch.empty(1024 * nreal, dtype=torch.int32, device=device)
    slots = torch.empty(1024 * nreal, dtype=torch.int32, device=device) if with_slots else None
    lane = torch.arange(128, device=device)
    for t0 in range(0, nreal, 1 << 16):
        t = torch.arange(t0, min(nreal, t0 + (1 << 16)), device=device)
        g = brow[t].long() - g0
        base = crow[:-1].reshape(-1, 8)[g] + 128 * (t - start[g])[:, None]  # (T, 8): each row's slot of brick t
        pos = (base[:, :, None] + lane).reshape(-1)
        values[pos] = bdata[t].reshape(-1)
        cols[pos] = (128 * bcol[t].long()[:, None, None] + lane).expand(-1, 8, -1).reshape(-1).to(torch.int32)
        if with_slots:
            slots[pos] = (1024 * t[:, None] + torch.arange(1024, device=device)).reshape(-1).to(torch.int32)
    # the stored zeros of the bricks are no entries of the CSR matrix
    nz = values != 0
    counts = torch.zeros(1024 * nreal + 1, dtype=torch.int64, device=device)
    counts[1:] = torch.cumsum(nz, 0)
    csr = torch.sparse_csr_tensor(counts[crow].to(torch.int32), cols[nz], values[nz], size=(m, n))
    return csr, slots[nz] if with_slots else None


def _library_spmm(S, x, quiet: bool = False):
    """One PyTorch call computing this rank's slab of S times x (every
    brick row of the slab): the BSR tensor with (8, 128) blocks, or, where
    PyTorch refuses those on CUDA, the CSR tensor of the same nonzeros
    (built on the card); ``quiet`` leaves out the line that says so.
    Returns (name, call)."""
    import torch

    bdata, bcol, _, _ = S._phys_components
    nreal = S._nreal
    g0, g1 = S._slab_rows
    m, n = (g1 - g0) * 8, S.nb * 128
    warnings.filterwarnings("ignore", message="Sparse (BSR|CSR) tensor support is in beta")
    warnings.filterwarnings("ignore", message="Sparse invariant checks are implicitly disabled")
    try:
        bsr = torch.sparse_bsr_tensor(S._brick_rowptr, bcol[:nreal], bdata[:nreal], size=(m, n))
        bsr @ x
        return "torch.sparse_bsr_tensor (8, 128) blocks @ x", lambda: bsr @ x
    except RuntimeError as e:
        if not quiet:
            print(f"library yardstick: torch.sparse_bsr_tensor @ x refused on CUDA ({str(e).splitlines()[0][:120]}); "
                  f"using torch.sparse_csr_tensor of the same matrix", flush=True)
    csr, _ = _csr_of(S, x.device)
    return f"torch.sparse_csr_tensor ({csr.values().numel()} nonzeros) @ x", lambda: csr @ x


def _k7_row(name, S, x, launches, err):
    """K7 (``spmm.cu``) at one of the main path's shapes beside its bound
    (the bricks, indices, masks, x and y once: bytes), its plain version and
    the library's sparse product: its CUDA-event median, which for a call
    this short times the host's launch, and its device time (``_device_ms``)."""
    from heat_tpu_torch.kernels import spmm as ks

    bdata, bcol, brow, bmask = S._phys_components
    m, n = S.shape
    k = x.shape[1]
    rowptr = S._brick_rowptr
    call = lambda: ks.brick_spmm(bdata, bcol, brow, bmask, rowptr, x, m)
    ms = _median_ms(call, 20)
    dev_ms = _device_ms(call, 20)
    plain_ms = _median_ms(lambda: ks.brick_spmm_plain(bdata, bcol, brow, bmask, x, m), 3)
    lib_name, lib_call = _library_spmm(S, x)
    y, y_lib = call(), lib_call()
    scale = ks.brick_spmm_plain(bdata.abs(), bcol, brow, bmask, x.abs(), m)
    _require(bool(((y - y_lib).abs() <= TOL_SPARSE * scale).all()), f"{lib_name} does not compute S @ x")
    del y, y_lib, scale
    library_ms = _median_ms(lib_call, 10)
    B, nreal = S.slab_bricks, S._slab_meta[0][2]
    nbytes = 4096 * B + 12 * B + 4 * (S.mb + 1) + 4 * k * (n + m)
    bound_ms, bound_by = _bound(nbytes, 2.0 * 1024 * nreal * k)
    print(
        f"{name} (K7, {nreal} bricks, k={k}): {ms:.4f} ms (CUDA events, host launch included), device time "
        f"(calls queued behind a spin) {dev_ms:.4f} ms, plain {plain_ms:.4f} ms, {lib_name} {library_ms:.4f} ms, bound {bound_ms:.4f} "
        f"ms ({bound_by}, {nbytes / 1e9:.4f} GB; {nbytes / (dev_ms * 1e-3) / 1e9:.1f} GB/s achieved on the device, "
        f"{bound_ms / dev_ms:.1%} of the bound)",
        flush=True,
    )
    return {
        "name": name, "route": "cuda", "source": "heat_tpu_torch/csrc/spmm.cu",
        "replaces": "heat_tpu/kernels/spmm.py:238", "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        "device_ms": dev_ms,
    }


def _k8_row(name, S, d, gen, launches, errs):
    """K8's Hopper kernel at one of the main path's shapes beside its bound
    (the bricks read and written, u and v once: bytes; the 3xTF32 operation
    bound and the FP32 CUDA-core one beside it), its plain version and
    spmm.cu's kernel on the same inputs (``pr4_ms``), timed in turns.
    ``errs`` is the largest error of each kernel against the plain version."""
    import torch

    from heat_tpu_torch.kernels import spmm as ks

    sdata, bcol, brow, _ = S._phys_components
    m, n = S.shape
    u = torch.randn(m, d, device=sdata.device, generator=gen)
    v = torch.randn(n, d, device=sdata.device, generator=gen)
    _require(ks.sddmm_sm90_serviceable(d, m, (u.data_ptr(), v.data_ptr(), sdata.data_ptr())),
             f"{name} is off K8's Hopper kernel")
    colorder = S._brick_colorder
    ms = _median_ms(lambda: ks.brick_sddmm(sdata, brow, bcol, *colorder, u, v), 10)
    pr4_ms = _median_ms(lambda: ks._brick_sddmm_spmm_cu(sdata, brow, bcol, *colorder, u, v), 10)
    ms_again = _median_ms(lambda: ks.brick_sddmm(sdata, brow, bcol, *colorder, u, v), 10)
    pr4_again = _median_ms(lambda: ks._brick_sddmm_spmm_cu(sdata, brow, bcol, *colorder, u, v), 10)
    plain_ms = _median_ms(lambda: ks.brick_sddmm_plain(sdata, brow, bcol, u, v), 3)
    # the library's SDDMM: torch.sparse.sampled_addmm on a CSR mask of S's
    # nonzeros gives u·vᵀ at each of them (beta=0); times S's values it must
    # equal K8's bricks there
    csr, slots = _csr_of(S, sdata.device, with_slots=True)
    vt = v.T
    library = lambda: torch.sparse.sampled_addmm(csr, u, vt, beta=0.0)
    nnz = slots.numel()
    at = torch.arange(0, nnz, max(1, nnz // (1 << 22)), device=u.device)  # up to 2^22 entries, evenly spread
    sampled = library().values()[at] * csr.values()[at]
    out = ks.brick_sddmm(sdata, brow, bcol, *colorder, u, v).reshape(-1)[slots[at].long()]
    scale = torch.sparse.sampled_addmm(csr, u.abs(), v.abs().T, beta=0.0).values()[at] * csr.values()[at].abs()
    lib_err = float(((sampled - out).abs() / scale).max())
    _require(lib_err <= TOL_SPARSE, f"torch.sparse.sampled_addmm times S's values is {lib_err:.3e} of the scale off "
                                    f"K8's bricks (tol {TOL_SPARSE})")
    del sampled, out, scale
    library_ms = _median_ms(library, 10)
    del csr, slots
    B = S.slab_bricks
    nbytes = 2 * 4096 * B + 8 * B + 4 * d * (m + n)
    flops = 1024.0 * B * (2 * d + 1)
    t_bytes, tf32_ms, fp32_ms = nbytes / HBM_BYTES_PER_S * 1e3, 3 * flops / TF32_FLOP_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= tf32_ms else (tf32_ms, "operations")
    print(
        f"{name} (K8 sddmm_sm90.cu, {B} bricks, d={d}): {ms:.4f} ms [{ms_again:.4f}], spmm.cu's kernel (pr4_ms) "
        f"{pr4_ms:.4f} ms [{pr4_again:.4f}], plain {plain_ms:.4f} ms, library torch.sparse.sampled_addmm on a CSR "
        f"mask of S's {nnz} nonzeros (u·vᵀ there; S's values times it within {lib_err:.2e} of K8's scale at "
        f"{at.numel()} of them) "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}; {nbytes / 1e9:.4f} GB, {flops / 1e9:.1f} GFLOP: 3xTF32 {tf32_ms:.4f} ms, FP32 CUDA cores "
        f"{fp32_ms:.4f} ms; {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s achieved, {bound_ms / ms:.1%} of the bound)",
        flush=True,
    )
    return {
        "name": name, "route": "cuda", "source": "heat_tpu_torch/csrc/sddmm_sm90.cu",
        "replaces": "heat_tpu/kernels/spmm.py:265", "launches": launches, "max_abs_err": errs[0],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        "library": "torch.sparse.sampled_addmm (CSR mask, beta=0)", "pr4_ms": pr4_ms, "pr4_err": errs[1], "bound_3xtf32_ms": tf32_ms, "bound_fp32_ms": fp32_ms,
    }


def sparse_timings(dev, inputs: dict, launches: dict, errs: dict) -> list:
    """K7 and K8 at the main-path shapes beside bound, plain version and
    library call; S @ x end to end; PageRank split into the host build and
    the fixpoint. Returns the kernel rows."""
    import numpy as np
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.graph.pagerank import _adjacency_to_scipy, _fixpoint, _transition

    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    rows = []
    S = ht.sparse.sparse_dbcsr_matrix(inputs["bsr"], split=0)
    x = torch.randn(SPMM_N, SPMM_K, device=dev, generator=gen)
    rows.append(_k7_row("brick_spmm_1gb", S, x, launches["spmm_1gb"], errs[f"spmm_1gb_k{SPMM_K}"]))
    rows.append(_k8_row("brick_sddmm_1gb", S, SDDMM_D, gen, launches["sddmm_1gb"], errs[f"sddmm_1gb_d{SDDMM_D}"]))
    e2e = _median_ms(lambda: S @ x, 20)
    print(f"spmm_1gb: S @ x {e2e:.4f} ms end to end (median of 20, CUDA events)", flush=True)
    del S

    C = card_matrix(dev, ht)
    for k in (SPMM_K, 1):
        xk = torch.randn(CARD_N, k, device=dev, generator=gen)
        rows.append(_k7_row(f"brick_spmm_card_k{k}", C, xk, launches[f"card_k{k}"], errs[f"card_k{k}"]))
    rows.append(_k8_row("brick_sddmm_card", C, SDDMM_D, gen, launches[f"card_sddmm_d{SDDMM_D}"],
                        errs[f"card_sddmm_d{SDDMM_D}"]))
    xk = torch.randn(CARD_N, SPMM_K, device=dev, generator=gen)
    e2e = _median_ms(lambda: C @ xk, 10)
    print(f"{CARD_N}^2: S @ x (k={SPMM_K}) {e2e:.4f} ms end to end (median of 10, CUDA events)", flush=True)
    del C, xk
    torch.cuda.empty_cache()

    graph = inputs["graph"]
    steps = {}
    for rep in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        csr = _adjacency_to_scipy(graph)
        t1 = time.perf_counter()
        M_host, dangling, _ = _transition(csr, np.float32)
        t2 = time.perf_counter()
        M = ht.sparse.sparse_dbcsr_matrix(M_host, dtype=ht.float32, split=0)
        dang = torch.from_numpy(dangling).to(dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        r, iters, _ = _fixpoint(M, dang, 0.85, PR_TOL, 200)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for key, sec in (("adjacency", t1 - t0), ("transition", t2 - t1), ("dbcsr", t3 - t2), ("fixpoint", t4 - t3)):
            steps.setdefault(key, []).append(sec * 1e3)
    med = {key: statistics.median(v) for key, v in steps.items()}
    build = med["adjacency"] + med["transition"] + med["dbcsr"]
    whole = _median_ms(lambda: ht.graph.pagerank(graph, tol=PR_TOL), 3)
    print(
        f"pagerank_2m ({iters} iterations): whole call {whole:.1f} ms (CUDA events, median of 3); host build "
        f"{build:.1f} ms = adjacency to scipy {med['adjacency']:.1f} + transition {med['transition']:.1f} + "
        f"sparse_dbcsr_matrix (tobsr, landing) {med['dbcsr']:.1f}; fixpoint {med['fixpoint']:.2f} ms = "
        f"{med['fixpoint'] / iters:.3f} ms per iteration (host clock with sync, median of 3)", flush=True,
    )
    rows.append(_k7_row("brick_spmm_pagerank", M, r[:, None].contiguous(), launches["pagerank"], errs["pagerank_k1"]))
    profile_breakdown("pagerank_2m fixpoint", lambda: _fixpoint(M, dang, 0.85, PR_TOL, 200))
    return rows


# --------------------------------------------------------------------- #
# attention: K9 under ht.nn                                             #
# --------------------------------------------------------------------- #
def _qkv(dev, gen, bh, s_q, s_kv, d, d_v, dtype, mult: float = 1.0):
    import torch

    q = (torch.randn(bh + (s_q, d), device=dev, generator=gen) * mult).to(dtype)
    k = torch.randn(bh + (s_kv, d), device=dev, generator=gen).to(dtype)
    v = torch.randn(bh + (s_kv, d_v), device=dev, generator=gen).to(dtype)
    return q, k, v


def _o_limit(ka, q, k, v, causal, ro):
    """The elementwise limit of |o - ro| for K9's o (TOL_ATT_*): float32
    1e-5 max|v| of each (batch, head) slice; bfloat16 3 · 2^-8 (|ro| + A),
    A the float32 attention of |v| on the same q and k."""
    import torch

    if q.dtype != torch.bfloat16:
        return TOL_ATT_F32 * v.float().abs().amax(dim=(-2, -1), keepdim=True)
    a, _ = ka.flash_attention_plain(q.float(), k.float(), v.float().abs(), causal)
    return TOL_ATT_BF16_O * 2.0**-8 * (ro.float().abs() + a)


def _o_errors(ka, o, ro, q, k, v, causal):
    """(max |o - ro| / its limit, max |o - ro|); the first must be <= 1."""
    if not o.numel():
        return 0.0, 0.0
    diff = (o.float() - ro.float()).abs()
    return float((diff / _o_limit(ka, q, k, v, causal, ro).clamp_min(1e-30)).max()), float(diff.max())


def _o_tol_text(dtype) -> str:
    import torch

    return f"{TOL_ATT_BF16_O:g} · 2^-8 (|ro| + A)" if dtype == torch.bfloat16 else f"{TOL_ATT_F32:g} max|v|"


def _att_errors(ka, o, lse, ro, rl, q, k, v, causal):
    """o's error as a share of its limit, max |Δo|, and max |Δlse| / (1 +
    |lse|), the -inf rows required to agree exactly."""
    import torch

    eo, abs_o = _o_errors(ka, o, ro, q, k, v, causal)
    dead, rdead = torch.isneginf(lse), torch.isneginf(rl)
    _require(torch.equal(dead, rdead), "K9 and its plain version disagree on the rows without keys")
    live = ~dead
    el = float(((lse - rl).abs() / (1 + rl.abs()))[live].max()) if bool(live.any()) else 0.0
    return eo, abs_o, el


def _lse_tol(dtype) -> float:
    import torch

    return TOL_ATT_BF16_LSE if dtype == torch.bfloat16 else TOL_ATT_F32


def _hopper_shape(q, k, v) -> bool:
    """Whether K9 should take its Hopper path (attention_sm90.cu) on these
    operands: bfloat16 at D = D_v in {64, 128, 256} or float32 at D = D_v
    = 64, every base and every stride but the last dim's on 16 bytes."""
    import torch

    es = q.element_size()
    aligned = all(t.data_ptr() % 16 == 0 and all(st * es % 16 == 0 for st in t.stride()[:-1]) for t in (q, k, v))
    dims = {torch.bfloat16: (64, 128, 256), torch.float32: (64,)}.get(q.dtype, ())
    return q.shape[-1] == v.shape[-1] and q.shape[-1] in dims and aligned


def _old_kernel(dtype) -> str:
    """attention.cu's kernel for ``dtype``."""
    import torch

    return "the mma.sync kernel" if dtype == torch.bfloat16 else "the FP32 kernel"


def _k9_case(ka, label, q, k, v, causal):
    """K9 against its plain version and against itself on a rerun, on the
    route its predicate picks. On the Hopper path attention.cu's kernel
    runs on the same inputs too: held against the plain version, and the
    Hopper path against it, each under the same limits. In float32 the
    library call's own error against the plain version is printed beside
    K9's. Returns the largest |Δo| against the plain version of the
    route's kernel and of attention.cu's kernel (None off the Hopper
    path)."""
    import torch

    launches, launches_sm90 = ka.ATTENTION_LAUNCHES, ka.ATTENTION_SM90_LAUNCHES
    o, lse = ka.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    hopper = _hopper_shape(q, k, v)
    _require(ka.ATTENTION_LAUNCHES == launches + 1, f"K9 ({label}) did not launch once")
    _require(ka.ATTENTION_SM90_LAUNCHES == launches_sm90 + int(hopper),
             f"K9 ({label}) {'did not take' if hopper else 'took'} the Hopper path")
    ro, rl = ka.flash_attention_plain(q, k, v, causal)
    eo, abs_o, el = _att_errors(ka, o, lse, ro, rl, q, k, v, causal)
    tol_l = _lse_tol(q.dtype)
    o2, l2 = ka.flash_attention(q, k, v, causal)
    rerun = bool(torch.equal(o, o2) and torch.equal(lse, l2))
    route = "attention_sm90" if hopper else "attention"
    vs_old, ok_old, abs_m = "", True, None
    if hopper:
        old = _old_kernel(q.dtype)
        mo, ml = ka._flash_attention_attention_cu(q, k, v, causal)
        em, abs_m, elm = _att_errors(ka, mo, ml, ro, rl, q, k, v, causal)
        ex, abs_x, elx = _att_errors(ka, o, lse, mo, ml, q, k, v, causal)
        ok_old = em <= 1 and elm <= tol_l and ex <= 1 and elx <= tol_l
        vs_old = (f"; {old} against the plain version: max |Δo| {abs_m:.3e}, {em:.3f} of the limit, "
                  f"lse err {elm:.3e}; the Hopper path against {old}: max |Δo| {abs_x:.3e}, "
                  f"{ex:.3f} of the limit, lse err {elx:.3e}")
    if q.dtype == torch.float32:
        # on copies: the library faults on views whose bases lie off 16 bytes
        scale = 1.0 / math.sqrt(q.shape[-1])
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        lo = torch.nn.functional.scaled_dot_product_attention(qc, kc, vc, is_causal=causal, scale=scale)
        del qc, kc, vc
        el_lib, abs_lib = _o_errors(ka, lo, ro, q, k, v, causal)
        vs_old += (f"; scaled_dot_product_attention against the plain version: max |Δo| {abs_lib:.3e}, "
                   f"{el_lib:.3f} of the limit")
        del lo
    print(
        f"K9 {route} ({label}, {tuple(q.shape)} x {tuple(v.shape)}, {str(q.dtype)[6:]}, causal={causal}): max |Δo| "
        f"{abs_o:.3e}, {eo:.3f} of its limit {_o_tol_text(q.dtype)}; lse err {el:.3e} of 1+|lse| (tol {tol_l}); "
        f"rerun identical {rerun}{vs_old}",
        flush=True,
    )
    _require(eo <= 1 and el <= tol_l and rerun and ok_old,
             f"K9 disagrees with its plain version, attention.cu's kernel or itself ({label})")
    return abs_o, abs_m


def check_attention(dev) -> dict:
    """K9 against its plain version at the main path's shapes and at ragged
    and boundary ones; the lse residual through the ring's combine; a
    strided read of a packed projection. Returns the main shapes' errors."""
    import torch

    from heat_tpu_torch.kernels import attention as ka

    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    f32, bf16 = torch.float32, torch.bfloat16
    errs = {}
    b, h, s, d = RA
    for dtype, causal, key in ((f32, True, "ra_f32_causal"), (f32, False, "ra_f32"), (bf16, True, "ra_bf16_causal")):
        errs[key] = _k9_case(ka, key, *_qkv(dev, gen, (b, h), s, s, d, d, dtype), causal)
    b, h, s, d = RAB
    errs["rab_bf16_causal"] = _k9_case(ka, "rab_bf16_causal", *_qkv(dev, gen, (b, h), s, s, d, d, bf16), True)
    b, h, s, d = SDPA_D256
    errs["bf16_d256"] = _k9_case(ka, "bf16_d256", *_qkv(dev, gen, (b, h), s, s, d, d, bf16), True)
    # the Hopper path at its ragged and boundary shapes, at every head dim
    # and dtype it takes (RA, RAB, heads of 256 and the cases below at
    # D = 64 take it too)
    for dtype, d in ((bf16, 64), (bf16, 128), (bf16, 256), (f32, 64)):
        tag = f"D = {d}" if dtype == bf16 else f"float32, D = {d}"
        for causal in (True, False):
            _k9_case(ka, f"ragged 1000, {tag}", *_qkv(dev, gen, (2, 3), 1000, 1000, d, d, dtype), causal)
        _k9_case(ka, f"causal, 300 x 1003, {tag}", *_qkv(dev, gen, (4,), 300, 1003, d, d, dtype), True)
        _k9_case(ka, f"S_q = 1, {tag}", *_qkv(dev, gen, (4, 8), 1, 4096, d, d, dtype), False)
        _k9_case(ka, f"scores x10, {tag}", *_qkv(dev, gen, (2, 8), 2048, 2048, d, d, dtype, mult=10.0), True)
        # the packed projection's heads, read in place by TMA: the bits of copies
        qkv = torch.randn(2, 300, 3, 4, d, device=dev, generator=gen).to(dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        _k9_case(ka, f"packed heads, {tag}", q, k, v, True)
        o, lse = ka.flash_attention(q, k, v, True)
        oc, lc = ka.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), True)
        _require(torch.equal(o, oc) and torch.equal(lse, lc),
                 f"K9's Hopper path on strided views differs from it on copies ({tag})")
    # bfloat16 shapes the Hopper path refuses, on the mma.sync kernel, causal:
    # its D_v <= 64 form (D = 48) and its 64 < D_v <= 128 form (D = 96, and
    # D = 128 read from views that start 2 bytes off 16)
    for d in (48, 96):
        _k9_case(ka, f"mma.sync, ragged causal, D = {d}", *_qkv(dev, gen, (2, 3), 1003, 1003, d, d, bf16), True)
        _k9_case(ka, f"mma.sync, causal, 300 x 1003, D = {d}", *_qkv(dev, gen, (4,), 300, 1003, d, d, bf16), True)
    q, k, v = (t[..., 1:129] for t in _qkv(dev, gen, (2, 3), 1003, 1003, 136, 136, bf16))
    _k9_case(ka, "mma.sync, causal, misaligned views, D = 128", q, k, v, True)
    # float32 shapes the Hopper path refuses, on the FP32 kernel, causal:
    # D = 128 (its 64 < D_v <= 128 form) and D = 64 read from views that
    # start 4 bytes off 16 (its D_v <= 64 form)
    _k9_case(ka, "FP32 kernel, ragged causal, D = 128", *_qkv(dev, gen, (2, 3), 1003, 1003, 128, 128, f32), True)
    q, k, v = (t[..., 1:65] for t in _qkv(dev, gen, (2, 3), 1003, 1003, 72, 72, f32))
    _k9_case(ka, "FP32 kernel, causal, misaligned views, D = 64", q, k, v, True)
    for dtype in (f32, bf16):
        _k9_case(ka, "ragged", *_qkv(dev, gen, (6,), 1000, 777, 72, 40, dtype), False)
        _k9_case(ka, "ragged causal", *_qkv(dev, gen, (2, 3), 1003, 1003, 64, 64, dtype), True)
        _k9_case(ka, "causal, S_q < S_kv", *_qkv(dev, gen, (4,), 300, 1003, 64, 64, dtype), True)
        _k9_case(ka, "D = 8", *_qkv(dev, gen, (2, 4), 64, 64, 8, 8, dtype), True)
        _k9_case(ka, "D = 256", *_qkv(dev, gen, (2, 2), 1000, 1000, 256, 256, dtype), True)
        _k9_case(ka, "D = 256, D_v = 64", *_qkv(dev, gen, (2,), 500, 700, 256, 64, dtype), False)
        _k9_case(ka, "S_q = 1", *_qkv(dev, gen, (4, 8), 1, 4096, 64, 64, dtype), False)
        _k9_case(ka, "scores x10", *_qkv(dev, gen, (2, 8), 2048, 2048, 64, 64, dtype, mult=10.0), True)
        # S_kv = 0: zeros and -inf, no launch
        q, k, v = _qkv(dev, gen, (2,), 5, 0, 16, 8, dtype)
        launches = ka.ATTENTION_LAUNCHES
        o, lse = ka.flash_attention(q, k, v, True)
        _require(ka.ATTENTION_LAUNCHES == launches and not o.any() and bool(torch.isneginf(lse).all()),
                 "S_kv = 0 launched or gave more than zeros and -inf")

        # the lse residual: K9 on the two halves of K/V, combined as the ring
        # combines its steps, against K9 on the whole
        b, h, s, d = RA
        q, k, v = _qkv(dev, gen, (b, h), s, s, d, d, dtype)
        half = s // 2
        o1, l1 = ka.flash_attention(q, k[..., :half, :], v[..., :half, :])
        o2, l2 = ka.flash_attention(q, k[..., half:, :], v[..., half:, :])
        o, lse = ka.combine_partials(o1, l1, o2, l2)
        ro, rl = ka.flash_attention(q, k, v)
        eo, abs_o, el = _att_errors(ka, o, lse, ro, rl, q, k, v, False)
        tol_l = _lse_tol(dtype)
        print(f"K9 lse identity ({str(dtype)[6:]}, two halves of {s} keys combined vs whole): max |Δo| "
              f"{abs_o:.3e}, {eo:.3f} of its limit {_o_tol_text(dtype)}; lse err {el:.3e} (tol {tol_l})", flush=True)
        _require(eo <= 1 and el <= tol_l, "K9's lse residual does not combine into the whole")

        # the heads of a packed projection, read in place: the same bits as
        # K9 on contiguous copies
        qkv = torch.randn(2, 300, 3, 4, 32, device=dev, generator=gen).to(dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        o, lse = ka.flash_attention(q, k, v, True)
        oc, lc = ka.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), True)
        _require(torch.equal(o, oc) and torch.equal(lse, lc), "K9 on strided views differs from K9 on copies")

    # MultiheadAttention's strided heads at MHA-1024 (RAB's attention shape)
    import heat_tpu_torch as ht

    _r1_zero()
    mha, x = _mha_inputs(dev, ht)
    torch.cuda.synchronize()
    _r1_read("mha_1024_init", 2, [3 * MHA_E * MHA_E, MHA_E * MHA_E])  # in_proj and out_proj, heat_tpu's init
    with torch.inference_mode():
        errs["mha_1024_heads"] = _k9_case(ka, "mha_1024 heads", *_mha_heads(mha, x), True)
    del mha, x

    # under autograd the public route launches K9 and differentiates the
    # plain version in the backward
    from heat_tpu_torch.nn.attention import _single_device_attention

    q, k, v = (t.requires_grad_() for t in _qkv(dev, gen, (2, 4), 300, 300, 32, 32, f32))
    launches = ka.ATTENTION_LAUNCHES
    grads = torch.autograd.grad(_single_device_attention(q, k, v, True).square().sum(), (q, k, v))
    ref = torch.autograd.grad(ka.flash_attention_plain(q, k, v, True)[0].square().sum(), (q, k, v))
    gerr = max(float((g - r).abs().max() / r.abs().max()) for g, r in zip(grads, ref))
    print(f"K9 under autograd: {ka.ATTENTION_LAUNCHES - launches} launch, gradients within {gerr:.2e} of the "
          f"plain version's (relative to their largest element; tol {TOL_ATT_F32})", flush=True)
    _require(ka.ATTENTION_LAUNCHES == launches + 1 and gerr <= TOL_ATT_F32, "K9's autograd route")
    del q, k, v, o, lse, grads, ref
    torch.cuda.empty_cache()
    return errs


def attention_path(dev):
    """The attention path through its public entry points at full size;
    returns K9's launch count of each call and the largest |Δo| of K9 on
    MultiheadAttention's heads."""
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.core import _threefry as tf
    from heat_tpu_torch.kernels import attention as ka
    from heat_tpu_torch.kernels import threefry as kt

    launches, launches_sm90, errs = {}, {}, {}

    def run(label: str, call, hopper: bool):
        ka.ATTENTION_LAUNCHES = ka.ATTENTION_SM90_LAUNCHES = 0
        out = call()
        torch.cuda.synchronize()
        launches[label], launches_sm90[label] = ka.ATTENTION_LAUNCHES, ka.ATTENTION_SM90_LAUNCHES
        _require(launches[label] == 1, f"{label} launched K9 {launches[label]} times, not once")
        _require(launches_sm90[label] == int(hopper),
                 f"{label} launched K9's Hopper path {launches_sm90[label]} times, not {int(hopper)}")
        return out

    def check(label, out, q, k, v, causal):
        ro, _ = ka.flash_attention_plain(q, k, v, causal)
        _require(out.shape == ro.shape and out.dtype == ro.dtype and bool(torch.isfinite(out).all()),
                 f"{label}: shape, dtype or values")
        err, abs_o = _o_errors(ka, out, ro, q, k, v, causal)
        print(f"{label}: {tuple(out.shape)} {str(out.dtype)[6:]}, K9 launches {launches[label]} (Hopper path "
              f"{launches_sm90[label]}), max |Δo| {abs_o:.3e} against the plain route, {err:.3f} of its limit "
              f"{_o_tol_text(q.dtype)}", flush=True)
        _require(err <= 1, f"{label} disagrees with the plain route")
        errs[label] = abs_o
        return abs_o

    ht.random.seed(5)
    for (b, h, s, d), dtype, label in ((RA, ht.float32, "ring_attention_ra_f32"),
                                       (RA, ht.bfloat16, "ring_attention_ra_bf16"),
                                       (RAB, ht.bfloat16, "ring_attention_rab_bf16")):
        _r1_zero()
        drawn = []
        for _ in range(3):
            _, seed, counter, _, _ = ht.random.get_state()
            drawn.append((ht.random.randn(b, h, s, d, dtype=dtype, split=2), _stream_key(seed, counter)))
        torch.cuda.synchronize()
        _r1_read(f"{label}_draw", 3, [b * h * s * d] * 3)
        # each operand bit for bit against R1's plain version (one rank
        # holds the whole draw)
        for name, (x, key) in zip("qkv", drawn):
            _require(x.lshape == x.gshape, f"{label}: {name} is not whole on one rank")
            _r1_sample_err(kt, x.larray, "normal", key, tf.Chunk.whole(x.gshape), dtype.torch_type(), (0.0, 1.0),
                           f"{label}_draw {name}")
        q, k, v = (x for x, _ in drawn)
        del drawn
        _require(q.larray.device == dev and q.split == 2, "q is not a split-2 array on the card")
        out = run(label, lambda: ht.nn.ring_attention(q, k, v, causal=True), True)
        _require(out.split == 2 and out.dtype is dtype and out.gshape == (b, h, s, d), f"{label}: result metadata")
        check(label, out.larray, q.larray, k.larray, v.larray, True)
    del q, k, v, out

    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    b, h, s, d = RA
    q, k, v = _qkv(dev, gen, (b, h), s, s, d, d, torch.float32)
    out = run("sdpa_ra_f32", lambda: ht.nn.functional.scaled_dot_product_attention(q, k, v), True)
    check("sdpa_ra_f32", out, q, k, v, False)
    # bfloat16 heads of 256, the widest K9 takes
    q, k, v = _qkv(dev, gen, SDPA_D256[:2], SDPA_D256[2], SDPA_D256[2], SDPA_D256[3], SDPA_D256[3], torch.bfloat16)
    out = run("sdpa_bf16_d256", lambda: ht.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True),
              True)
    check("sdpa_bf16_d256", out, q, k, v, True)
    del q, k, v, out

    _r1_zero()
    mha, x = _mha_inputs(dev, ht)
    torch.cuda.synchronize()
    _r1_read("mha_1024_init", 2, [3 * MHA_E * MHA_E, MHA_E * MHA_E])  # in_proj and out_proj, heat_tpu's init
    k_in, k_out = tf.split(tf.seed_key(MHA_SEED))
    for name, w, key, bound in (("in_proj", mha.in_proj, k_in, _mha_bounds()[0]),
                                ("out_proj", mha.out_proj, k_out, _mha_bounds()[1])):
        _r1_sample_err(kt, w.detach(), "uniform", key, tf.Chunk.whole(tuple(w.shape)), torch.bfloat16,
                       (-bound, bound), f"mha_1024_init {name}")
    with torch.inference_mode():
        out = run("mha_1024", lambda: mha(x), True)
        # K9 on the module's strided heads of its packed projection, held
        # against the plain version elementwise; then the module's output
        # against that o through out_proj, the same ops on the same inputs
        # (at most one bf16 rounding apart, of the product and of the sum)
        q, k, v = _mha_heads(mha, x)
        o, _ = ka.flash_attention(q, k, v, True)
        check("mha_1024", o, q, k, v, True)
        y = o.transpose(1, 2).reshape(x.shape) @ mha.out_proj
        ref = y + mha.out_bias
        bound = 2.0**-7 * (y.float().abs() + ref.float().abs())
        ok = bool(((out.float() - ref.float()).abs() <= bound).all()) and bool(torch.isfinite(out).all())
    print(f"MultiheadAttention({MHA_E}, {MHA_H}, causal, bf16) on {tuple(x.shape)}: {tuple(out.shape)}, "
          f"K9 launches {launches['mha_1024']} (Hopper path {launches_sm90['mha_1024']}), equal to K9's o through "
          f"out_proj within one bf16 rounding: {ok}", flush=True)
    _require(ok and out.shape == x.shape, "MultiheadAttention is not K9's attention through its projections")
    del out, ref, y, o, q, k, v
    torch.cuda.empty_cache()
    return launches, launches_sm90, errs


def _mha_inputs(dev, ht):
    import torch

    from heat_tpu_torch.core._threefry import seed_key

    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    mha = ht.nn.MultiheadAttention(MHA_E, MHA_H, causal=True, dtype=ht.bfloat16, key=seed_key(MHA_SEED))
    with torch.no_grad():  # non-zero biases, so that they are exercised
        mha.in_bias.uniform_(-0.1, 0.1, generator=gen)
        mha.out_bias.uniform_(-0.1, 0.1, generator=gen)
    x = torch.randn(1, RAB[2], MHA_E, device=dev, generator=gen).to(torch.bfloat16)
    return mha, x


def _mha_heads(mha, x):
    """q, k and v of ``MultiheadAttention.forward``: (B, H, S, D) strided
    views of its packed projection."""
    b, s, e = x.shape
    qkv = (x @ mha.in_proj + mha.in_bias).reshape(b, s, 3, mha.num_heads, mha.head_dim)
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


def _k9_row(name, q, k, v, causal, launches: int, launches_sm90: int, errs: tuple):
    """K9 at one of the main path's shapes, on the kernel its predicate
    picks there, beside its bound, its plain version and the library call
    on the same inputs (whose agreement is checked first). ``launches`` and
    ``launches_sm90`` are K9's launches and the Hopper path's in the main
    path's call at this shape; ``errs`` is the largest |Δo| against the
    plain version of that kernel and of attention.cu's kernel (None off the
    Hopper path). On the Hopper path the row also carries attention.cu's
    kernel's time on the same inputs (``attention_cu_ms``: mma.sync for
    bf16, the FP32 kernel for float32) and its error
    (``attention_cu_err``). A float32 row's bound is that of 3xTF32 on the
    tensor cores (``bound_fp32_ms``: FP32 on the CUDA cores)."""
    import torch

    from heat_tpu_torch.kernels import attention as ka

    hopper = _hopper_shape(q, k, v)
    source = "heat_tpu_torch/csrc/attention_sm90.cu" if hopper else "heat_tpu_torch/csrc/attention.cu"
    *lead, s_q, d = q.shape
    s_kv, d_v = k.shape[-2], v.shape[-1]
    bh = math.prod(lead)
    scale = 1.0 / math.sqrt(d)
    ms = _median_ms(lambda: ka.flash_attention(q, k, v, causal), 10)
    plain_ms = _median_ms(lambda: ka.flash_attention_plain(q, k, v, causal), 3)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal, scale=scale)
    o, _ = ka.flash_attention(q, k, v, causal)
    # both against the exact result: twice K9's float32 limit; in bfloat16
    # each is within 2^-8 (|o| + A), inside the limit with o for ro
    lib_err, lib_abs = _o_errors(ka, lib(), o, q, k, v, causal)
    lim = lib_err / 2 if q.dtype == torch.float32 else lib_err
    _require(lim <= 1, f"scaled_dot_product_attention does not compute K9's function ({name}: {lib_abs:.3e})")
    del o
    library_ms = _median_ms(lib, 10)
    pairs = sum(min(i + 1, s_kv) for i in range(s_q)) if causal else s_q * s_kv
    flops = 2.0 * (d + d_v) * bh * pairs
    es = q.element_size()
    nbytes = es * bh * (s_q * d + s_kv * (d + d_v) + s_q * d_v) + 4 * bh * s_q
    bf16 = q.dtype == torch.bfloat16
    peak = BF16_FLOP_PER_S if bf16 else TF32_FLOP_PER_S / 3  # float32 as 3xTF32
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    fp32_ms = max(flops / FP32_FLOP_PER_S * 1e3, t_bytes)
    extra = "" if bf16 else f"; FP32 on the CUDA cores {fp32_ms:.4f} ms"
    if hopper:
        old_ms = _median_ms(lambda: ka._flash_attention_attention_cu(q, k, v, causal), 10)
        extra += f"; {_old_kernel(q.dtype)} of attention.cu {old_ms:.4f} ms ({old_ms / ms:.2f}x)"
    print(
        f"{name} (K9 {source.rsplit('/', 1)[-1]}, {tuple(q.shape)}, {str(q.dtype)[6:]}, causal={causal}): "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} ms (agrees to "
        f"{lib_abs:.2e}, {lim:.3f} of its limit), bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.1f} GFLOP at "
        f"{peak / 1e12:.0f} TFLOP/s{'' if bf16 else ' (3xTF32)'}, {nbytes / 1e6:.1f} MB; "
        f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s achieved, {bound_ms / ms:.1%} of the bound){extra}", flush=True,
    )
    row = {
        "name": name, "route": "cuda", "source": source, "replaces": "heat_tpu/nn/attention.py:637, :537",
        "launches": launches_sm90 if hopper else launches - launches_sm90, "max_abs_err": errs[0],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }
    if not bf16:
        row.update(bound_fp32_ms=fp32_ms)
    if hopper:
        row.update(attention_cu_ms=old_ms, attention_cu_err=errs[1])
    return row


def attention_timings(dev, launches: dict, launches_sm90: dict, errs: dict, path_errs: dict) -> list:
    """K9 at the main path's shapes beside bound, plain version and
    library call, the Hopper path also beside attention.cu's kernel; the
    public calls end to end; a profile of one MultiheadAttention forward.
    Returns the kernel rows."""
    import torch

    import heat_tpu_torch as ht

    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    rows = []

    def row(key, path, q, k, v, causal, errs_of):
        rows.append(_k9_row(f"flash_attention_{key}", q, k, v, causal, launches[path], launches_sm90[path], errs_of))

    b, h, s, d = RA
    for dtype, causal, key, path in ((torch.float32, True, "ra_f32_causal", "ring_attention_ra_f32"),
                                     (torch.float32, False, "ra_f32", "sdpa_ra_f32"),
                                     (torch.bfloat16, True, "ra_bf16_causal", "ring_attention_ra_bf16")):
        row(key, path, *_qkv(dev, gen, (b, h), s, s, d, d, dtype), causal, errs[key])
    b, h, s, d = RAB
    row("rab_bf16_causal", "ring_attention_rab_bf16", *_qkv(dev, gen, (b, h), s, s, d, d, torch.bfloat16), True,
        errs["rab_bf16_causal"])
    b, h, s, d = SDPA_D256
    row("bf16_d256", "sdpa_bf16_d256", *_qkv(dev, gen, (b, h), s, s, d, d, torch.bfloat16), True,
        (path_errs["sdpa_bf16_d256"], errs["bf16_d256"][1]))

    ht.random.seed(6)
    for (b, h, s, d), dtype, label in ((RA, ht.float32, "RA f32"), (RA, ht.bfloat16, "RA bf16"),
                                       (RAB, ht.bfloat16, "RAB bf16")):
        q, k, v = (ht.random.randn(b, h, s, d, dtype=dtype, split=2) for _ in range(3))
        call_ms = _median_ms(lambda: ht.nn.ring_attention(q, k, v, causal=True), 10)
        print(f"ring_attention {label} causal {tuple(q.shape)}: {call_ms:.4f} ms a call (CUDA events, median of 10)",
              flush=True)
    b, h, s, d = SDPA_D256
    q, k, v = _qkv(dev, gen, (b, h), s, s, d, d, torch.bfloat16)
    call_ms = _median_ms(lambda: ht.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True), 10)
    print(f"scaled_dot_product_attention bf16 causal {tuple(q.shape)}: {call_ms:.4f} ms a call (CUDA events, median "
          f"of 10)", flush=True)
    del q, k, v

    _r1_zero()
    mha, x = _mha_inputs(dev, ht)
    torch.cuda.synchronize()
    _r1_read("mha_1024_init", 2, [3 * MHA_E * MHA_E, MHA_E * MHA_E])  # in_proj and out_proj, heat_tpu's init
    with torch.inference_mode():
        fwd_ms = _median_ms(lambda: mha(x), 10)
        row("mha_1024", "mha_1024", *_mha_heads(mha, x), True, (path_errs["mha_1024"], errs["mha_1024_heads"][1]))
        proj_flops = 2.0 * RAB[2] * MHA_E * 4 * MHA_E
        print(f"MultiheadAttention({MHA_E}, {MHA_H}, causal, bf16) forward on {tuple(x.shape)}: {fwd_ms:.4f} ms "
              f"(CUDA events, median of 10); projections {proj_flops / 1e9:.1f} GFLOP, bound "
              f"{proj_flops / BF16_FLOP_PER_S * 1e3:.4f} ms", flush=True)
        profile_breakdown(f"MultiheadAttention({MHA_E}, {MHA_H}) forward {tuple(x.shape)} bf16", lambda: mha(x))
    return rows


# ---------------------------------------------------------------------------
# relayout: K5 (pack) and K6 (unpack) of the packed pivot
# ---------------------------------------------------------------------------
def _raw(t):
    """The raw words of ``t`` as an integer tensor: equality of these is
    equality bit for bit (NaN payloads and -0.0 included)."""
    import torch

    words = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64, 16: torch.int64}
    return t.contiguous().reshape(-1).view(words[t.element_size()])


def _random_of(gen, n: int, dtype, dev):
    """n elements of ``dtype`` with random raw words (random 0/1 for bool)."""
    import torch

    if dtype == torch.bool:
        return torch.randint(0, 2, (n,), generator=gen, device=dev, dtype=torch.uint8).bool()
    es = torch.empty(0, dtype=dtype).element_size()
    return torch.randint(0, 256, (n * es,), generator=gen, device=dev, dtype=torch.uint8).view(dtype)


def _k56_case(kr, label: str, x, rows: int, c_in: int, c_out: int, p: int) -> None:
    """K5 on x, then K6 on K5's output, each against its plain version bit
    for bit, each launching once (none when there are no rows)."""
    import torch

    before = kr.PACK_LAUNCHES, kr.UNPACK_LAUNCHES
    packed = kr.pack_rows(x, rows, c_in, c_out, p)
    back = kr.unpack_rows(packed, rows, c_out, c_in, p)
    torch.cuda.synchronize()
    want = kr.pack_rows_plain(x, rows, c_in, c_out, p)
    ok = torch.equal(_raw(packed), _raw(want)) and torch.equal(_raw(back), _raw(kr.unpack_rows_plain(want, rows, c_out, c_in, p)))
    ok = ok and torch.equal(_raw(back), _raw(x))
    launched = int(rows > 0)
    counted = (kr.PACK_LAUNCHES - before[0], kr.UNPACK_LAUNCHES - before[1]) == (launched, launched)
    print(f"K5/K6 {label} ({rows} rows, {c_in} <-> {c_out} over p={p}, {str(x.dtype)[6:]}): "
          f"{'equal bit for bit' if ok else 'DIFFER'}, launches {'as expected' if counted else 'WRONG'}", flush=True)
    _require(ok, f"K5/K6 differ from their plain versions at {label}")
    _require(counted, f"K5/K6 launch counts at {label}")


def check_relayout(dev) -> dict:
    """K5 and K6 against their plain versions bit for bit at the executor's
    per-rank shapes (the 1 GB move over 8 ranks, (2048, 64) <-> (8192, 16)
    over 4), ragged and degenerate shapes, a 64-bit index case, six dtypes
    and special float32 bits; returns the main shape's errors."""
    import torch

    from heat_tpu_torch.kernels import relayout as kr

    gen = torch.Generator(device=dev)
    gen.manual_seed(30)
    rows, c_in, c_out, p = RELAYOUT_P8
    x = torch.randn(rows * c_in, device=dev, generator=gen)
    _k56_case(kr, "the 1 GB move's per-rank shape at p = 8", x, rows, c_in, c_out, p)
    packed = kr.pack_rows(x, rows, c_in, c_out, p)
    errs = {"relayout_pack": float((packed - kr.pack_rows_plain(x, rows, c_in, c_out, p)).abs().max())}
    errs["relayout_unpack"] = float((kr.unpack_rows(packed, rows, c_out, c_in, p) - x).abs().max())
    del x, packed
    for shape in ((2048, 16, 16, 4), (512, 64, 64, 4)):
        _k56_case(kr, "(2048, 64) <-> (8192, 16) per rank at p = 4", torch.randn(shape[0] * shape[1], device=dev,
                  generator=gen), *shape)
    for dtype in (torch.bool, torch.int8, torch.bfloat16, torch.float32, torch.float64, torch.complex64):
        for shape in ((1003, 777, 784, 8), (7, 13, 15, 5), (1, 25, 32, 8), (5, 7, 7, 1), (6, 1, 8, 8), (0, 25, 32, 8)):
            _k56_case(kr, "ragged/degenerate", _random_of(gen, shape[0] * shape[1], dtype, dev), *shape)
    _k56_case(kr, "16-byte words", _random_of(gen, 64 * 13, torch.complex128, dev), 64, 13, 16, 4)
    specials = torch.tensor([float("nan"), -0.0, float("inf"), -float("inf"), 0.0, 1e-40, -1.5, 3.0] * 100, device=dev)
    words = specials.view(torch.int32)
    words[::8] = 0x7FC12345  # a quiet NaN with a payload
    words[5::8] = 0xFFC00001 - (1 << 32)  # a NaN with its sign bit set
    words[7::8] = 0x7F800001  # a signalling NaN
    _k56_case(kr, "NaN payloads and -0.0", specials, 32, 25, 32, 8)
    big = RELAYOUT_WIDE
    _k56_case(kr, "64-bit offsets (rows x c_out > 2^31)", _random_of(gen, big[0] * big[1], torch.bool, dev), *big)
    return errs


def relayout_path(dev) -> dict:
    """The slice's main path. On the card, 8 ranks of the packed pivot run
    in one process (``LocalWorld``: the exchange is a device copy, not
    NCCL): the 1 GB move (1000, 250000) split 1 -> (10,000,000, 25)
    new_split=1 and back, planned by the port's planner as heat_tpu plans
    them (packed-pivot, 9 all-to-alls each). Then the world-size-1 entry
    points. Returns K5's launches on the forward move and K6's on the
    reverse."""
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.kernels import relayout as kr
    from heat_tpu_torch.redistribution import executor, planner

    print("packed pivot: 8 ranks emulated in one process; exchange is a device copy, not NCCL", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    x = torch.randn(*RESHAPE_1GB[0], device=dev, generator=gen)
    p = 8
    world = executor.LocalWorld(p)
    launches = {}
    shards = list(x.chunk(p, dim=1))
    for name, want in (("reshape_split1_1gb_p8", x.reshape(RESHAPE_1GB[1])), ("reshape_packed_rev_p8", x)):
        spec = dict(planner.golden_specs())[name]
        sched = planner.plan(spec)
        _require((sched.strategy, sched.collective_counts()) == ("packed-pivot", {"all-to-all": 9}),
                 f"{name} plans {sched.strategy} {sched.collective_counts()}, not packed-pivot with 9 all-to-alls")
        body = executor.program(spec, sched)
        shards = [s.contiguous() for s in shards]
        torch.cuda.synchronize()
        kr.PACK_LAUNCHES = kr.UNPACK_LAUNCHES = 0
        t0 = time.perf_counter()
        shards = world.run(body, shards)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches[name] = (kr.PACK_LAUNCHES, kr.UNPACK_LAUNCHES)
        whole = torch.cat(shards, dim=1)
        ok = torch.equal(_raw(whole), _raw(want))
        print(f"{name} {spec!r}: K5 launches {launches[name][0]}, K6 launches {launches[name][1]}, "
              f"all-to-alls per rank {world.counts[0]}, {'equal to torch.reshape' if ok else 'DIFFERS'} bit for bit; "
              f"{wall:.1f} ms wall for all 8 emulated ranks (not a distributed timing)", flush=True)
        _require(ok, f"{name}: the emulated ranks' result differs from torch.reshape")
        _require(all(c == sched.collective_counts() for c in world.counts), f"{name}: collectives differ from the plan")
    _require(launches["reshape_split1_1gb_p8"] == (8, 0), "the forward move must launch K5 once a rank and K6 never")
    _require(launches["reshape_packed_rev_p8"] == (0, 8), "the reverse move must launch K6 once a rank and K5 never")
    del shards, whole

    # world size 1 through the public entry points
    n = 2**27
    s = ht.arange(n, split=0).sum()
    _require(s.dtype is ht.int64 and s.item() == n * (n - 1) // 2,
             f"ht.arange(2**27, split=0).sum() gave {s.item()} ({s.dtype.__name__}), not {n * (n - 1) // 2} (int64)")
    A = ht.array(x, split=1)
    B = A.resplit(0)
    C = ht.reshape(A, RESHAPE_1GB[1], new_split=1)
    plan = ht.redistribution.explain(A, reshape=RESHAPE_1GB[1], new_split=1)
    ok = torch.equal(B.larray, x) and B.split == 0 and torch.equal(C.larray, x.reshape(RESHAPE_1GB[1])) and C.split == 1
    print(f"world size 1: ht.arange(2**27, split=0).sum() = {s.item()} (int64); resplit(0) and "
          f"reshape({RESHAPE_1GB[1]}, new_split=1) of the 1 GB array: {'equal' if ok else 'DIFFER'} to torch.reshape; "
          f"plan {plan.strategy}", flush=True)
    _require(ok and plan.strategy == "local", "world size 1 resplit/reshape")
    return {"pack": launches["reshape_split1_1gb_p8"][0], "unpack": launches["reshape_packed_rev_p8"][1]}


def relayout_timings(dev, launches: dict, errs: dict) -> list:
    """K5 and K6 at the per-rank shape of the 1 GB move over 8 ranks,
    beside their bound (bytes read and written over 3.35 TB/s), their plain
    versions and a clone() of the 160 MB buffer (the card's copy rate).
    At this shape each row's 25 columns are padded to 32: the packed
    layout holds zeros the shard does not, so it is no permuted view of
    the shard (K5), and K6 drops them, so its output is no view of the
    packed buffer: no single PyTorch call computes either, and
    ``library_ms`` stays null. Beside them, ``composed_ms`` times the two
    calls that do (K5: ``F.pad``, then the permuted view's
    ``.contiguous()``; K6: the permuted view's ``.contiguous()``, then the
    slice's)."""
    import torch

    from heat_tpu_torch.kernels import relayout as kr

    gen = torch.Generator(device=dev)
    gen.manual_seed(32)
    rows, c_in, c_out, p = RELAYOUT_P8
    x = torch.randn(rows * c_in, device=dev, generator=gen)
    packed = kr.pack_rows(x, rows, c_in, c_out, p)
    nbytes = 4.0 * rows * (c_in + c_out)
    bound_ms, bound_by = _bound(nbytes, 0.0)
    clone_ms = _median_ms(lambda: packed.clone(), 20)
    print(f"copy rate: clone() of the {packed.numel() * 4 / 1e6:.0f} MB packed buffer {clone_ms:.4f} ms "
          f"({2 * packed.numel() * 4 / (clone_ms * 1e-3) / 1e12:.3f} TB/s read + write)", flush=True)
    import torch.nn.functional as F

    cpp_out = c_out // p
    composed = {
        "relayout_pack": lambda: F.pad(x.view(rows, c_in), (0, c_out - c_in)).view(rows, p, cpp_out).permute(
            1, 0, 2).contiguous(),
        "relayout_unpack": lambda: packed.view(p, rows, cpp_out).permute(1, 0, 2).contiguous().view(rows, c_out)[
            :, :c_in].contiguous(),
    }
    _require(torch.equal(composed["relayout_pack"]().reshape(-1), packed.reshape(-1))
             and torch.equal(composed["relayout_unpack"]().reshape(-1), x), "the composed calls differ from K5/K6")
    rows_out = []
    for name, kernel, (c_from, c_to), call, plain, line in (
        ("relayout_pack", "K5", (c_in, c_out), lambda: kr.pack_rows(x, rows, c_in, c_out, p),
         lambda: kr.pack_rows_plain(x, rows, c_in, c_out, p), "heat_tpu/kernels/relayout.py:169"),
        ("relayout_unpack", "K6", (c_out, c_in), lambda: kr.unpack_rows(packed, rows, c_out, c_in, p),
         lambda: kr.unpack_rows_plain(packed, rows, c_out, c_in, p), "heat_tpu/kernels/relayout.py:194"),
    ):
        ms = _median_ms(call, 20)
        plain_ms = _median_ms(plain, 5)
        composed_ms = _median_ms(composed[name], 20)
        print(f"{name} ({kernel}, {rows} rows, {c_from} -> {c_to} columns over p={p}, float32): {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, composed (two calls; no single call) {composed_ms:.4f} ms, "
              f"clone {clone_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{nbytes / 1e6:.0f} MB; {nbytes / (ms * 1e-3) / 1e12:.3f} TB/s achieved)", flush=True)
        rows_out.append({
            "name": name, "route": "cuda", "source": "heat_tpu_torch/csrc/relayout.cu", "replaces": line,
            "launches": launches["pack" if kernel == "K5" else "unpack"], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "composed_ms": composed_ms, "clone_ms": clone_ms,
        })
    return rows_out


# --------------------------------------------------------------------- #
# the wire: Q1, the quantized training step, the 1 GB quantized move    #
# --------------------------------------------------------------------- #
Q1_SOURCE = "heat_tpu_torch/csrc/quant.cu"
# Q1 computes heat_tpu's codec, which XLA fuses into the programs around
# it: no pallas_call to replace
Q1_REPLACES = "none: heat_tpu/kernels/quant.py:174 (_encode_int8) and :194 (_decode_int8) are XLA, not Pallas"
Q1_N = 1 << 28  # float32 elements of Q1's timed row (1 GiB)
WIRE_STEPS = 3  # SGD steps of the quantized training runs
WIRE_TOPOLOGY_1GB = "2x4"  # the 1 GB move's two-tier run: 2 nodes of 4 emulated ranks
TOL_WIRE_DELTA = 0.05  # the quantized steps' parameter change against the exact steps', relative (see _wire_delta)
DISK_COMMIT_BYTES = 256 << 20


def _q1_zero():
    from heat_tpu_torch.kernels import quant

    quant.ENCODE_LAUNCHES = quant.DECODE_LAUNCHES = 0


def _q1_read() -> tuple:
    from heat_tpu_torch.kernels import quant

    return quant.ENCODE_LAUNCHES, quant.DECODE_LAUNCHES


def _q1_case(quant, label: str, x) -> None:
    """Q1's encode of ``x`` (B, n) bit for bit against its plain version on
    the card (codes and scale bytes), its decode exactly; one launch each."""
    import torch

    e0, d0 = _q1_read()
    w = quant.encode_blocks(x, "int8")
    _require(_q1_read()[0] == e0 + (1 if x.numel() else 0), f"Q1 {label}: encode did not launch once")
    _require(torch.equal(w, quant.encode_int8_plain(x)), f"Q1 {label}: encode differs from its plain version")
    back = quant.decode_blocks(w, x.shape[1], "int8")
    _require(_q1_read()[1] == d0 + (1 if x.numel() else 0), f"Q1 {label}: decode did not launch once")
    want = quant.decode_int8_plain(w, x.shape[1])
    _require(torch.equal(back.view(torch.int32), want.view(torch.int32)), f"Q1 {label}: decode differs")


def check_quant(dev) -> dict:
    """Q1 against its plain version on the card, bit for bit: the CPU
    test's cases (normal data, zero tiles, NaN and ±inf tiles, a ragged last
    tile, rows not on 16 bytes, rounding ties, a wide range, −0.0,
    subnormals), then 2^28 normals as one row and as the flat DP
    all-reduce's 4 blocks of the CNN's gradient. Returns the errors (0.0:
    bit for bit)."""
    import numpy as np
    import torch

    from heat_tpu_torch.kernels import quant

    rng = np.random.default_rng(5)
    cases = {"normal": rng.standard_normal((3, 2500)) * 7, "ragged": rng.standard_normal((4, 1030)),
             "odd_rows": rng.standard_normal((7, 1027)), "tiny": rng.standard_normal((5, 3)),
             "ties": (np.arange(2048).reshape(2, 1024) - 1000) * 0.5,
             "wide": rng.standard_normal((2, 4096)) * 10.0 ** rng.integers(-30, 30, (2, 4096)),
             "neg_zero": np.full((1, 1024), -0.0), "subnormal": rng.standard_normal((2, 1500)) * 1e-39}
    s = rng.standard_normal((3, 2048))
    s[0, 5], s[0, 7], s[1, 9], s[1, 1500:1600], s[2, :1024] = np.nan, np.inf, -np.inf, np.nan, np.inf
    z = rng.standard_normal((2, 3072))
    z[0, 1024:2048] = 0.0
    cases.update(specials=s, zero_tiles=z)
    for label, a in cases.items():
        _q1_case(quant, label, torch.from_numpy(np.asarray(a, np.float32)).to(dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(33)
    x = torch.randn(1, Q1_N, device=dev, generator=gen)
    _q1_case(quant, "2^28", x)
    n = _cnn_params()
    _q1_case(quant, "cnn_blocks", torch.randn(WORLD, -(-n // WORLD), device=dev, generator=gen))
    print(f"Q1: encode bit for bit (codes and scale bytes) and decode exactly against the plain version on "
          f"{len(cases) + 2} cases, 2^28 normals included", flush=True)
    del x
    torch.cuda.empty_cache()
    return {"quant_encode": 0.0, "quant_decode": 0.0}


def _cnn_params() -> int:
    s = TRAIN_SIDE
    fc = 64 * ((s - 4) // 2) ** 2 * 128 + 128 * TRAIN_CLASSES
    return 32 * 9 + 32 + 64 * 32 * 9 + 64 + fc + 128 + TRAIN_CLASSES


def _wire_delta(params, init, exact) -> float:
    """The quantized steps' parameter change against the same steps on an
    exact wire (the same dropout keys), ‖Δq − Δe‖/‖Δe‖: each step's
    gradient crosses two int8 legs (2^-7 of a tile's absmax each, error
    feedback carrying it on), so a few times 2^-7 (TOL_WIRE_DELTA)."""
    return float(((params - exact).double().norm() / (exact - init).double().norm().clamp_min(1e-30)))


def _disk_commit_rate() -> float:
    """Bytes/s of a durable commit of DISK_COMMIT_BYTES (write, fsync,
    rename) in a fresh temporary directory: the lattice's ``disk`` edge."""
    import os
    import shutil
    import tempfile

    blob = os.urandom(1 << 20) * (DISK_COMMIT_BYTES >> 20)
    root = tempfile.mkdtemp(prefix="heat_disk_")
    try:
        rates = []
        for k in range(3):
            path = os.path.join(root, f"commit{k}")
            t0 = time.perf_counter()
            with open(path + ".tmp", "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(path + ".tmp", path)
            rates.append(DISK_COMMIT_BYTES / (time.perf_counter() - t0))
            os.remove(path)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return statistics.median(rates)


def wire_path(dev) -> dict:
    """The wire at world size 1 and in 8 emulated ranks:

    (a) examples/mnist.py's CNN on the global batch of 8192,
        ``WIRE_STEPS`` SGD steps with ``wire_quant="int8"`` and ``"bf16"``:
        in a world of one rank the mode is the exact step (heat_tpu's
        contract), so the parameters must equal the exact optimizer's
        within ``TOL_TRAIN_CPU`` (cuDNN's backward sums in no fixed order)
        and Q1 must not launch;
    (b) ``reshape_split1_1gb`` over 8 ranks in one process (``LocalWorld``:
        the exchange is a device copy, not NCCL) planned under
        ``HEAT_TPU_WIRE_QUANT=1``, flat and at ``HEAT_TPU_TOPOLOGY=2x4``:
        Q1 encodes each lap's destination blocks and decodes what arrives,
        once a codec step a rank; the result within the codec's bound of
        ``torch.reshape`` (2 legs of 2^-7 of the largest |x|).
    Also the disk commit rate the lattice's ``disk`` edge carries."""
    import os

    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.kernels import quant
    from heat_tpu_torch.redistribution import executor, planner

    t_phase = time.perf_counter()
    res = {"disk_commit_gbps": _disk_commit_rate() / 1e9}
    print(f"disk: durable commit (write, fsync, rename) of {DISK_COMMIT_BYTES >> 20} MiB, median of 3: "
          f"{res['disk_commit_gbps']:.4f} GB/s", flush=True)
    images, labels = _mnist_arrays(TRAIN_KEY, TRAIN_BATCH)
    x = ht.array(images[:, None].astype("float32") / 255.0, split=0)
    y = ht.array(labels.astype("int32"), split=0)
    runs = {}
    for mode in (None, "int8", "bf16"):
        model = ht.nn.DataParallel(_cnn(ht), key=TRAIN_KEY)
        opt = ht.optim.DataParallelOptimizer(ht.optim.SGD(lr=TRAIN_LR), model, wire_quant=mode)
        _q1_zero()
        for _ in range(WIRE_STEPS):
            opt.step(x, y)
        torch.cuda.synchronize()
        launches = _q1_read()
        runs[mode] = (_params_of(model), launches, _median_ms(lambda: opt.step(x, y), 3))
        _require(mode is None or launches == (0, 0), f"world size 1, wire_quant={mode}: Q1 launched {launches}")
    # one rank runs the exact step; cuDNN's backward adds in no fixed order,
    # so two exact runs differ in their last bits: TOL_TRAIN_CPU
    errs = {mode: _rel(runs[mode][0], runs[None][0]) for mode in ("int8", "bf16")}
    _require(all(e <= TOL_TRAIN_CPU for e in errs.values()),
             f"world size 1, wire_quant: the parameters differ from the exact step's by {errs}")
    res["size1"] = {str(m): {"ms": v[2], "q1": v[1]} for m, v in runs.items()}
    res["size1_err"] = errs
    print(f"wire (a) world size 1: CNN, {WIRE_STEPS} SGD steps of {TRAIN_BATCH} with wire_quant None/int8/bf16 (one "
          f"rank: the exact step, as in heat_tpu): parameters against the exact run's {errs} (tol {TOL_TRAIN_CPU}: "
          f"cuDNN's backward), Q1 launches {[v[1] for v in runs.values()]}; ms a step "
          f"{[round(v[2], 4) for v in runs.values()]}", flush=True)
    del runs, x, y

    print("wire (b): 8 ranks emulated in one process; exchange is a device copy, not NCCL", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    a = torch.randn(*RESHAPE_1GB[0], device=dev, generator=gen)
    want = a.reshape(RESHAPE_1GB[1])
    bound = 2 * 2.0**-7 * 1.01 * float(a.abs().max())
    spec = dict(planner.golden_specs())["reshape_split1_1gb_p8"]
    p = 8
    res["move"] = {}
    for label, wire, topology in (("exact", "0", "flat"), ("flat", "1", "flat"),
                                  (WIRE_TOPOLOGY_1GB, "1", WIRE_TOPOLOGY_1GB)):
        old = {k: os.environ.get(k) for k in ("HEAT_TPU_WIRE_QUANT", "HEAT_TPU_TOPOLOGY")}
        os.environ.update(HEAT_TPU_WIRE_QUANT=wire, HEAT_TPU_TOPOLOGY=topology)
        try:
            sched = planner.plan(spec)
        finally:
            for k, v in old.items():
                os.environ.pop(k) if v is None else os.environ.update({k: v})
        n_q = sum(st.kind == "quantize" for st in sched.steps)
        _require(label == "exact" or (sched.quant is not None and sched.quant["mode"] == "int8" and n_q > 0),
                 f"the 1 GB move at {topology} under HEAT_TPU_WIRE_QUANT=1 planned no codec")
        world = executor.LocalWorld(p)
        body = executor.program(spec, sched)
        shards = [s.contiguous() for s in a.chunk(p, dim=1)]
        torch.cuda.synchronize()
        _q1_zero()
        t0 = time.perf_counter()
        out = world.run(body, shards)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = _q1_read()
        got = torch.cat(out, dim=1)
        err = float((got - want).abs().max())
        counts_ok = all(c == sched.collective_counts() for c in world.counts)
        _require(launches == (p * n_q, p * n_q), f"the 1 GB move at {topology}: Q1 launched {launches}, "
                 f"not {n_q} encodes and decodes a rank")
        limit = 0.0 if label == "exact" else bound
        _require(counts_ok and err <= limit, f"the 1 GB move at {topology}: counts {world.counts[0]} against "
                 f"{sched.collective_counts()}, max |Δ| {err:.3e} (bound {limit:.3e})")
        sent = sched.quant["bytes_sent"] if sched.quant else sched.bytes_moved
        res["move"][label] = {"strategy": sched.strategy, "q1_a_rank": (launches[0] // p, launches[1] // p),
                              "wall_ms": wall, "err": err, "bound": limit, "counts": world.counts[0],
                              "bytes_raw": sched.wire_bytes_raw, "bytes_sent": sent}
        print(f"wire (b) {spec!r} at {topology}, HEAT_TPU_WIRE_QUANT={wire}: {sched.strategy}, collectives a rank "
              f"{world.counts[0]}, Q1 launches a rank {res['move'][label]['q1_a_rank']} (encode, decode), wire "
              f"bytes a rank {sent} of {sched.wire_bytes_raw}; max |Δ| against torch.reshape {err:.4e} (bound "
              f"{limit:.4e}: two int8 legs, 0 exact); {wall:.1f} ms wall for all 8 emulated ranks (not a "
              f"distributed timing)", flush=True)
        del out, got, shards
    del a, want
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    print(f"wire phase: {res['seconds']:.1f} s", flush=True)
    return res


def quant_timings(dev, wire: dict, world: dict, errs: dict) -> list:
    """Q1's rows: encode and decode of 2^28 float32 (one row) and of the
    CNN's gradient as the flat all-reduce's 4 blocks, CUDA events (median
    of 20) and device time (queued calls), beside the bound (bytes: 4 n
    read and n + 4 n/1024 written, or the reverse, over 3.35 TB/s), the
    plain version and the bf16 mode's ATen cast (context: no library call
    computes the int8 codec, ``library_ms`` null)."""
    import torch

    from heat_tpu_torch.kernels import quant

    gen = torch.Generator(device=dev)
    gen.manual_seed(34)
    rows_out = []
    move = wire["move"]
    main_launches = {"move_1gb_flat_a_rank": move["flat"]["q1_a_rank"],
                     f"move_1gb_{WIRE_TOPOLOGY_1GB}_a_rank": move[WIRE_TOPOLOGY_1GB]["q1_a_rank"],
                     "world_dp_a_rank": world["q1"]}
    n_cnn = _cnn_params()
    for label, shape in (("2^28", (1, Q1_N)), ("cnn_gradient_blocks", (WORLD, -(-n_cnn // WORLD)))):
        x = torch.randn(*shape, device=dev, generator=gen)
        w = quant.encode_blocks(x, "int8")
        n = x.numel()
        nbytes = 4.0 * n + w.numel()
        bound_ms, bound_by = _bound(nbytes, 0.0)
        cast_ms = _median_ms(lambda: quant.encode_blocks(x, "bf16"), 20)
        for name, call, plain in (
            ("quant_encode", lambda: quant.encode_blocks(x, "int8"), lambda: quant.encode_int8_plain(x)),
            ("quant_decode", lambda: quant.decode_blocks(w, shape[1], "int8"),
             lambda: quant.decode_int8_plain(w, shape[1])),
        ):
            ms = _median_ms(call, 20)
            dev_ms = _device_ms(call, 20)
            plain_ms = _median_ms(plain, 5)
            enc, dec = main_launches["move_1gb_flat_a_rank"]
            launches = 8 * (enc if name == "quant_encode" else dec)
            print(f"{name} (Q1, {shape[0]} x {shape[1]} float32, {label}): {ms:.4f} ms (events), device "
                  f"{dev_ms:.4f} ms, plain {plain_ms:.4f} ms, bf16 cast {cast_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}: {nbytes / 1e6:.1f} MB; {nbytes / (dev_ms * 1e-3) / 1e12:.3f} TB/s on the device); "
                  f"launches on the main path {main_launches}", flush=True)
            rows_out.append({
                "name": f"{name}_{label}", "route": "cuda", "source": Q1_SOURCE, "replaces": Q1_REPLACES,
                "launches": launches, "max_abs_err": errs[name], "ms": ms, "device_ms": dev_ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                "bf16_cast_ms": cast_ms, "main_launches": main_launches,
            })
        del x, w
    torch.cuda.empty_cache()
    return rows_out


WORLD_RING_HSVD = (8192, 1024)  # a rank's split-0 shard of a rank-8 operand
WORLD_RING_MATMUL = (4096, 16384, 4096)  # (m, k, n): a split 1, b split 0
WORLD_RING_POLAR = (16384, 512)
WORLD_RING_LU = 4096
TOL_RING = 1e-5  # the collective matmul and polar against the barrier form, of the largest magnitude


def _world_wire(ht, comm, moved: dict, rank: int, dev) -> dict:
    """The wire across the 4 ranks on one card: (a) the CNN's
    ``WIRE_STEPS`` SGD steps on the global batch of 8192 with
    ``wire_quant="int8"`` and ``"bf16"``, flat and at
    ``HEAT_TPU_TOPOLOGY=2x2`` (every rank's parameters equal bit for bit,
    their change within ``TOL_WIRE_DELTA`` of the exact steps'; Q1 two
    encodes and four decodes a rank a step flat, one and two at 2x2, none
    under bf16); (c) the rings under ``HEAT_TPU_REDIST_OVERLAP=1`` against
    their barrier forms: ``hsvd_rank`` (its TSQR merge) and ``lu`` bit for
    bit, the collective ``matmul`` and ``polar`` within ``TOL_RING`` and one
    result on every rank, each form's collectives and ms."""
    import os

    import torch

    t_phase = time.perf_counter()
    out = {"dp": {}, "rings": {}}
    images, labels = _mnist_arrays(TRAIN_KEY, TRAIN_BATCH)
    x = ht.array(images[:, None].astype("float32") / 255.0, split=0)
    y = ht.array(labels.astype("int32"), split=0)
    from heat_tpu_torch.kernels import quant

    def run(mode):
        model = ht.nn.DataParallel(_cnn(ht), key=TRAIN_KEY)
        opt = ht.optim.DataParallelOptimizer(ht.optim.SGD(lr=TRAIN_LR), model, wire_quant=mode)
        return model, opt

    # the reference: the same steps (each rank's dropout key folded with its
    # rank) with the codec's all-reduce replaced by an exact one
    model, opt = run("int8")
    init = _params_of(model).clone()
    codec = quant.quantized_allreduce_sum
    quant.quantized_allreduce_sum = lambda h, c, mode: (c.allreduce(h), torch.zeros_like(h))
    try:
        for _ in range(WIRE_STEPS):
            opt.step(x, y)
    finally:
        quant.quantized_allreduce_sum = codec
    exact = _params_of(model)
    q1_per_step = {}
    for mode in ("int8", "bf16"):
        for topology in ("flat", "2x2"):
            os.environ["HEAT_TPU_TOPOLOGY"] = topology
            try:
                model, opt = run(mode)
                comm.counts.clear()
                moved.clear()
                _q1_zero()
                losses = [float(opt.step(x, y)) for _ in range(WIRE_STEPS)]
                torch.cuda.synchronize()
                launches, counts, nbytes = _q1_read(), dict(comm.counts), dict(moved)
                mine = _params_of(model)
                every = comm.allgather(mine[None])
                same = all(torch.equal(every[q], every[0]) for q in range(WORLD))
                delta = _wire_delta(mine, init, exact)
                per = (2, 4) if topology == "flat" else (1, 2)
                want = tuple(WIRE_STEPS * v for v in per) if mode == "int8" else (0, 0)
                _every_rank_ok(comm, same and delta <= TOL_WIRE_DELTA and launches == want
                               and all(math.isfinite(v) for v in losses),
                               f"quantized DP {mode} at {topology}: parameters equal on every rank {same}, change "
                               f"against the exact steps' {delta:.3e} (tol {TOL_WIRE_DELTA}), Q1 {launches} (want "
                               f"{want}), losses {losses}")
                ms = _world_ms(lambda: opt.step(x, y), 3)
            finally:
                os.environ.pop("HEAT_TPU_TOPOLOGY", None)
            if mode == "int8":
                q1_per_step[topology] = per
            out["dp"][f"{mode}_{topology}"] = {"losses": losses, "delta": delta, "q1": launches, "counts": counts,
                                               "bytes": nbytes, "ms": ms}
    out["q1"] = q1_per_step
    del x, y
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev)
    gen.manual_seed(9600)
    m, n = WORLD_RING_HSVD
    u, _ = torch.linalg.qr(torch.randn(WORLD * m, 8, device=dev, generator=gen))
    v, _ = torch.linalg.qr(torch.randn(n, 8, device=dev, generator=gen))
    whole = (u * torch.arange(8, 0, -1, device=dev, dtype=torch.float32)) @ v.T
    rank8 = ht.array(whole[rank * m : (rank + 1) * m].contiguous(), is_split=0)
    mm, kk, nn_ = WORLD_RING_MATMUL
    a = ht.array(torch.randn(mm, kk, device=dev, generator=gen)[:, rank * kk // WORLD : (rank + 1) * kk // WORLD]
                 .contiguous(), is_split=1)
    b = ht.array(torch.randn(kk, nn_, device=dev, generator=gen)[rank * kk // WORLD : (rank + 1) * kk // WORLD]
                 .contiguous(), is_split=0)
    pm, pn = WORLD_RING_POLAR
    pa = ht.array(torch.randn(pm, pn, device=dev, generator=gen)[rank * pm // WORLD : (rank + 1) * pm // WORLD]
                  .contiguous(), is_split=0)
    ln = WORLD_RING_LU
    la = ht.array((torch.randn(ln, ln, device=dev, generator=gen) / ln**0.5
                   + 3 * torch.eye(ln, device=dev))[rank * ln // WORLD : (rank + 1) * ln // WORLD].contiguous(),
                  is_split=0)
    calls = {
        "hsvd_rank": (lambda: ht.linalg.hsvd_rank(rank8, 8, compute_sv=True)[:3], True),
        "matmul": (lambda: (ht.matmul(a, b),), False),
        "polar": (lambda: ht.linalg.polar(pa), False),
        "lu": (lambda: ht.linalg.lu(la), True),
    }
    for name, (call, exact_ring) in calls.items():
        forms = {}
        for overlap in ("1", "0"):
            os.environ["HEAT_TPU_REDIST_OVERLAP"] = overlap
            try:
                comm.counts.clear()
                res = call()
                torch.cuda.synchronize()
                counts = dict(comm.counts)
                ms = _world_ms(call, 2)
            finally:
                os.environ.pop("HEAT_TPU_REDIST_OVERLAP", None)
            forms[overlap] = ([(t.larray if hasattr(t, "larray") else torch.as_tensor(t)).clone() for t in res],
                              counts, ms)
        ring, barrier = forms["1"], forms["0"]
        if exact_ring:
            ok = all(torch.equal(r.view(torch.uint8) if r.dtype.is_floating_point else r,
                                 s.view(torch.uint8) if s.dtype.is_floating_point else s)
                     for r, s in zip(ring[0], barrier[0]))
            err = 0.0
        else:
            err = max(float((r - s).abs().max() / s.abs().max().clamp_min(1e-30)) for r, s in zip(ring[0], barrier[0]))
            rep = ring[0][-1] if name == "polar" else ring[0][0]  # H, the product: replicated
            every = comm.allgather(rep[None])
            ok = err <= TOL_RING and all(torch.equal(every[q], every[0]) for q in range(WORLD))
        _every_rank_ok(comm, ok and "collective-permute" in ring[1] and "collective-permute" not in barrier[1],
                       f"ring {name}: against the barrier form {'bit for bit' if exact_ring else f'{err:.3e}'}, "
                       f"collectives {ring[1]} against {barrier[1]}")
        out["rings"][name] = {"ring_counts": ring[1], "barrier_counts": barrier[1], "ring_ms": ring[2],
                              "barrier_ms": barrier[2], "err": err}
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _report_world_wire(per: list, shared: str) -> dict:
    """Print the world's wire phase; returns Q1's launches a rank a step."""
    for key in per[0]["dp"]:
        d = [p["dp"][key] for p in per]
        print(f"world wire (a) CNN, {WIRE_STEPS} SGD steps of {TRAIN_BATCH}, wire {key}: losses "
              f"{[round(v, 4) for v in d[0]['losses']]}, parameters equal on every rank, change against the exact "
              f"steps' {max(x['delta'] for x in d):.3e} (tol {TOL_WIRE_DELTA}); Q1 launches a rank {d[0]['q1']} "
              f"(encode, decode); {d[0]['ms']:.4f} ms a step (rank 0, median of 3; ranks "
              f"{[round(x['ms'], 4) for x in d]}); collectives a rank {d[0]['counts']}, bytes a rank put in "
              f"{d[0]['bytes']}; {shared}", flush=True)
    for name in per[0]["rings"]:
        r = [p["rings"][name] for p in per]
        print(f"world ring {name} (HEAT_TPU_REDIST_OVERLAP=1 against 0): ring {r[0]['ring_ms']:.4f} ms, barrier "
              f"{r[0]['barrier_ms']:.4f} ms (rank 0, median of 2); collectives a rank {r[0]['ring_counts']} against "
              f"{r[0]['barrier_counts']}; against the barrier form "
              f"{'bit for bit' if r[0]['err'] == 0.0 else f'{max(x['err'] for x in r):.3e} (tol {TOL_RING})'}; "
              f"{shared}", flush=True)
    print(f"world wire phase: {max(p['seconds'] for p in per):.1f} s", flush=True)
    return {"q1": per[0]["q1"], "dp": {k: [p["dp"][k]["q1"] for p in per] for k in per[0]["dp"]},
            "rings": {k: per[0]["rings"][k] for k in per[0]["rings"]}}


# --------------------------------------------------------------------- #
# the NumPy surface (op machinery, arithmetic, statistics)               #
# --------------------------------------------------------------------- #
SURFACE_SEED = 16  # the seed of the surface phase's draws
SURFACE_REPS = 5
SURFACE_Q = [5.0, 50.0, 95.0]


def _first_index_of_max(t, dim: int):
    """The first index of each lane's maximum along ``dim`` (no NaN in
    ``t``): an independent formula for ``argmax``."""
    import torch

    m = t.amax(dim=dim, keepdim=True)
    shape = [1] * t.ndim
    shape[dim] = t.shape[dim]
    at = torch.arange(t.shape[dim], device=t.device).reshape(shape)
    return torch.where(t == m, at, t.shape[dim]).amin(dim=dim)


def _quantile_ref(sorted_values, q, method: str):
    """``jnp.percentile``'s value of sorted float32 values (one lane): the
    positions q·(n − 1) in float64, linear interpolation in float64 rounded
    to float32, ``nearest`` the lower element up to half way."""
    import torch

    n = sorted_values.numel()
    out = []
    for qi in q:
        pos = qi / 100.0 * (n - 1)
        lo, hi = math.floor(pos), math.ceil(pos)
        vlo, vhi = sorted_values[lo].double(), sorted_values[hi].double()
        w = pos - lo
        if method == "nearest":
            out.append(sorted_values[lo] if w <= 0.5 else sorted_values[hi])
        else:
            out.append((vlo * (1.0 - w) + vhi * w).float())
    return torch.stack(out)


def surface_path(dev) -> dict:
    """The op machinery and the NumPy surface on the north-star operand
    (``ht.random.randn(65536, 8192, split=0)``, 2.15 GB float32): A + A,
    A * 2.0, (A − A.mean(axis=0)) / A.std(axis=0), ht.exp(A), (A > 0).sum(),
    abs(A).max(), A.argmax(axis=1), ht.cumsum(A, axis=0) and A.var(); then
    ht.median and ht.percentile(x, [5, 50, 95]) (linear and nearest) of
    sort_1gb's 2^27 float32, which sort through K4. Each result is held
    against an independent torch formula on the same card tensor
    (float64 for the reductions; exactly for integers, comparisons,
    argmax, the extremes and the nearest percentile; a stated relative
    tolerance otherwise) and timed under CUDA events beside its byte
    bound (each operand read once, the result written once, over 3.35
    TB/s). Returns the rows and K4's launches a call."""
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.kernels import sort as ks

    ht.random.seed(SURFACE_SEED)
    _r1_zero()
    A = ht.random.randn(M, N, split=0)
    torch.cuda.synchronize()
    _r1_read("surface_draw", 1, [M * N])
    a = A.larray
    _require(a.device == dev and A.dtype is ht.float32, "the surface operand is not float32 on the card")
    a64 = a.double()
    gb = 4.0 * M * N
    rows = []

    def record(label: str, call, nbytes: float, check, tol_text: str):
        out = call()
        torch.cuda.synchronize()
        err = check(out)
        ok = err is not None and err <= 0 if tol_text == "exact" else err is not None and err <= 1.0
        del out
        ms = _median_ms(call, SURFACE_REPS)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        row = {"name": label, "ms": round(ms, 4), "bound_ms": round(bound, 4), "bound_by": "bytes",
               "bytes": nbytes, "err": err, "tol": tol_text}
        rows.append(row)
        print(f"surface {label}: {ms:.4f} ms (CUDA events, median of {SURFACE_REPS}), bound {bound:.4f} ms "
              f"({nbytes / 1e9:.4f} GB over 3.35 TB/s); against the torch formula: {tol_text}, "
              f"{format(err, '.3e') + ' of its limit' if tol_text != 'exact' else ('equal' if ok else 'DIFFERS')}", flush=True)
        _require(ok, f"surface {label} disagrees with its torch formula ({err} against {tol_text})")

    def rel(out, ref, scale):  # |Δ| over the scale, in units of the tolerance
        return lambda tol: float(((out.double() - ref).abs() / scale).max()) / tol

    record("A + A", lambda: A + A, 2 * gb,
           lambda o: 0.0 if o.split == 0 and torch.equal(o.larray, a * 2) else 1.0, "exact")
    record("A * 2.0", lambda: A * 2.0, 2 * gb,
           lambda o: 0.0 if o.split == 0 and torch.equal(o.larray, a + a) else 1.0, "exact")
    ref = (a64 - a64.mean(0)) / a64.std(0, unbiased=False)
    record("(A - A.mean(axis=0)) / A.std(axis=0)", lambda: (A - A.mean(axis=0)) / A.std(axis=0), 2 * gb,
           lambda o: rel(o.larray, ref, ref.abs() + 1.0)(1e-5), "|Δ| <= 1e-5 (1 + |ref|), ref in float64")
    del ref
    ref = torch.exp(a64)
    record("ht.exp(A)", lambda: ht.exp(A), 2 * gb, lambda o: rel(o.larray, ref, ref.abs())(1e-6),
           "rel 1e-6 of float64 exp")
    del ref
    positive = int((a64 > 0).sum())
    record("(A > 0).sum()", lambda: (A > 0).sum(), gb,
           lambda o: 0.0 if o.dtype is ht.int64 and int(o.item()) == positive else 1.0, "exact")
    top = float(max(a64.max(), -a64.min()))
    record("abs(A).max()", lambda: abs(A).max(), gb, lambda o: 0.0 if float(o.item()) == top else 1.0, "exact")
    first = _first_index_of_max(a, 1)
    record("A.argmax(axis=1)", lambda: A.argmax(axis=1), gb + 8.0 * M,
           lambda o: 0.0 if o.split == 0 and torch.equal(o.larray, first) else 1.0, "exact")
    del first
    ref = torch.cumsum(a64, 0)
    scale = torch.cumsum(a64.abs(), 0)
    record("ht.cumsum(A, axis=0)", lambda: ht.cumsum(A, axis=0), 2 * gb,
           lambda o: rel(o.larray, ref, scale)(1e-5), "|Δ| <= 1e-5 of the running sum of |x|")
    del ref, scale
    var = float(a64.var(unbiased=False))
    record("A.var()", lambda: A.var(), gb, lambda o: abs(float(o.item()) - var) / var / 1e-5,
           "rel 1e-5 of the float64 variance")
    del a64, A, a
    torch.cuda.empty_cache()

    _r1_zero()
    x = ht.random.randn(SORT_N, split=0)
    torch.cuda.synchronize()
    _r1_read("surface_sort_draw", 1, [SORT_N])
    sorted_x = torch.sort(x.larray).values
    launches = {}
    for label, call, q, method in (("ht.median(x)", lambda: ht.median(x), [50.0], "linear"),
                                   (f"ht.percentile(x, {SURFACE_Q})", lambda: ht.percentile(x, SURFACE_Q), SURFACE_Q,
                                    "linear"),
                                   (f"ht.percentile(x, {SURFACE_Q}, nearest)",
                                    lambda: ht.percentile(x, SURFACE_Q, interpolation="nearest"), SURFACE_Q, "nearest")):
        want = _quantile_ref(sorted_x, q, method)
        ks.SORT_LAUNCHES = 0
        got = call()
        torch.cuda.synchronize()
        launches[label] = ks.SORT_LAUNCHES
        print(f"{label}: K4 launches {launches[label]}", flush=True)
        _require(launches[label] > 0, f"{label} ran without K4")
        record(label, call, 4.0 * SORT_N, lambda o: 0.0 if torch.equal(o.larray.reshape(-1), want) else 1.0, "exact")
    del x, sorted_x
    torch.cuda.empty_cache()
    return {"rows": rows, "launches": launches}


INDEXING_SEED = 17  # the seed of the indexing phase's draws
INDEXING_REPS = 5
INDEXING_ROWS = 1000  # rows gathered by A[idx], idx = ht.topk(A[:, 0], 1000)[1]


def indexing_path(dev) -> dict:
    """Indexing, assignment, where/nonzero, the factories and repr on the
    north-star operand (``ht.random.randn(65536, 8192, split=0)``, R1):
    ``A[1000:60000:3, ::2]``, ``A[:, 4097]``, the element mask ``A[A > 2.5]``,
    the row mask ``A[A[:, 0] > 0]``, ``ht.nonzero(A > 3.5)``, ``ht.where(A >
    0, A, 0.0)``, the gather ``A[idx]`` of ``idx = ht.topk(A[:, 0], 1000)[1]``
    (K4), the writes ``A[A < -4.0] = 0.0``, ``A[idx] = 0.0`` and
    ``A[100:200] = B[:100]``, ``ht.ones``, ``ht.full`` and ``ht.linspace`` at
    the operand's size, and ``repr(A)``. Each result is held against an
    independent torch formula on the same card tensor, exactly (linspace
    within float32's last bit), and timed under CUDA events beside its
    byte bound (what the call must read once plus write once, over 3.35
    TB/s). Returns the rows and K4's launches under ``topk``."""
    import numpy as np
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.core import printing
    from heat_tpu_torch.kernels import sort as ks

    ht.random.seed(INDEXING_SEED)
    _r1_zero()
    A = ht.random.randn(M, N, split=0)
    B = ht.random.randn(256, N, split=0)
    torch.cuda.synchronize()
    _r1_read("indexing_draw", 2, [M * N, 256 * N])
    a = A.larray
    _require(a.device == dev and A.dtype is ht.float32 and A.split == 0, "the indexing operand is not float32 on the card")
    rows = []

    def record(label: str, call, nbytes: float, ok, tol_text: str = "exact", reps: int = INDEXING_REPS):
        out = call()
        torch.cuda.synchronize()
        err = ok(out)
        del out
        ms = _median_ms(call, reps)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append({"name": label, "ms": round(ms, 4), "bound_ms": round(bound, 6), "bound_by": "bytes",
                     "bytes": nbytes, "err": err, "tol": tol_text})
        print(f"indexing {label}: {ms:.4f} ms (CUDA events, median of {reps}), bound {bound:.6f} ms "
              f"({nbytes / 1e9:.6f} GB over 3.35 TB/s); against the torch formula: {tol_text}, "
              f"{'equal' if err == 0 else format(err, '.3e') + ' of its limit'}", flush=True)
        _require(err is not None and (err == 0 if tol_text == "exact" else err <= 1.0),
                 f"indexing {label} disagrees with its torch formula ({err} against {tol_text})")

    def exact(ref, split):
        return lambda o: 0 if o.split == split and torch.equal(o.larray, ref) else 1

    gb = 4.0 * M * N
    ref = a[1000:60000:3, ::2]
    record("A[1000:60000:3, ::2]", lambda: A[1000:60000:3, ::2], 2 * 4.0 * ref.numel(), exact(ref, 0))
    ref = a[:, 4097]
    record("A[:, 4097]", lambda: A[:, 4097], 2 * 4.0 * M, exact(ref, 0))
    ref = torch.masked_select(a, a > 2.5)
    record("A[A > 2.5]", lambda: A[A > 2.5], gb + 4.0 * ref.numel(), exact(ref, 0))
    n_elements = ref.numel()
    ref = a[a[:, 0] > 0]
    record("A[A[:, 0] > 0]", lambda: A[A[:, 0] > 0], 2 * 4.0 * ref.numel(), exact(ref, 0))
    n_rows = ref.shape[0]
    ref = torch.nonzero(a > 3.5)
    record("ht.nonzero(A > 3.5)", lambda: ht.nonzero(A > 3.5), gb + 8.0 * ref.numel(), exact(ref, 0))
    ref = torch.where(a > 0, a, torch.zeros((), device=dev))
    record("ht.where(A > 0, A, 0.0)", lambda: ht.where(A > 0, A, 0.0), 2 * gb, exact(ref, 0))
    del ref
    torch.cuda.empty_cache()

    ks.SORT_LAUNCHES = 0
    idx = ht.topk(A[:, 0], INDEXING_ROWS)[1]
    torch.cuda.synchronize()
    topk_launches = ks.SORT_LAUNCHES
    want = torch.topk(a[:, 0], INDEXING_ROWS)
    _require(topk_launches > 0 and torch.equal(idx.larray, want.indices),
             f"ht.topk(A[:, 0], {INDEXING_ROWS}) ran without K4 ({topk_launches}) or differs from torch.topk")
    print(f"ht.topk(A[:, 0], {INDEXING_ROWS}): K4 launches {topk_launches}, indices equal torch.topk's", flush=True)
    row_bytes = 4.0 * N * INDEXING_ROWS
    record(f"A[idx], idx = ht.topk(A[:, 0], {INDEXING_ROWS})[1]", lambda: A[idx], 2 * row_bytes + 8.0 * INDEXING_ROWS,
           exact(a[want.indices], None))

    expect = a.clone()
    expect[expect < -4.0] = 0.0
    n_low = int((a < -4.0).sum())

    def write_low():
        A[A < -4.0] = 0.0
    record("A[A < -4.0] = 0.0", lambda: (write_low(), A)[1], gb + 4.0 * n_low, lambda o: 0 if torch.equal(a, expect)
           else 1)
    expect[want.indices] = 0.0

    def write_rows():
        A[idx] = 0.0
    record("A[idx] = 0.0", lambda: (write_rows(), A)[1], row_bytes + 8.0 * INDEXING_ROWS,
           lambda o: 0 if torch.equal(a, expect) else 1)
    expect[100:200] = B.larray[:100]

    def write_slab():
        A[100:200] = B[:100]
    record("A[100:200] = B[:100]", lambda: (write_slab(), A)[1], 2 * 4.0 * 100 * N,
           lambda o: 0 if torch.equal(a, expect) else 1)
    del expect
    torch.cuda.empty_cache()

    record("ht.ones((65536, 8192), split=0)", lambda: ht.ones((M, N), split=0), gb,
           lambda o: 0 if o.split == 0 and bool((o.larray == 1).all()) else 1)
    record("ht.full((65536, 8192), 2.5, split=0)", lambda: ht.full((M, N), 2.5, split=0), gb,
           lambda o: 0 if o.split == 0 and o.dtype is ht.float32 and bool((o.larray == 2.5).all()) else 1)
    n = M * N
    lin = torch.linspace(0.0, 1.0, n, dtype=torch.float64, device=dev)

    def last_bit(o):  # |Δ| in units of float32's last bit of the formula's value (at least 2^-24)
        err = (o.larray.double() - lin).abs() / (lin.abs() * 2.0 ** -23).clamp_min(2.0 ** -24)
        return float(err.max()) if o.split == 0 else 2.0
    record(f"ht.linspace(0, 1, {n}, split=0)", lambda: ht.linspace(0.0, 1.0, n, split=0), gb, last_bit,
           "within float32's last bit of torch.linspace in float64")
    del lin
    torch.cuda.empty_cache()

    text = repr(A)
    opts = printing.get_printoptions()
    e = opts["edgeitems"]
    _require(opts == {"precision": 4, "threshold": 1000, "edgeitems": 3, "linewidth": 120, "sci_mode": None},
             f"the print options are not torch's profile: {opts}")
    block = printing._edge_block(A, e)
    host = a[[0, 1, 2, M - 3, M - 2, M - 1]][:, [0, 1, 2, N - 3, N - 2, N - 1]].cpu().numpy()
    # NumPy's own summary of a 32 x 32 host array (1024 elements, over the
    # threshold) whose edge items are the operand's: it formats only the
    # items it shows, so its text is the operand's, with no edge block
    pad = np.zeros((32, 32), dtype=np.float32)
    pad[np.ix_(np.r_[0:3, 29:32], np.r_[0:3, 29:32])] = host
    with np.printoptions(precision=4, threshold=1000, edgeitems=3, linewidth=120, suppress=True):
        body = np.array2string(pad, separator=", ")
    want = f"DNDarray({body}, dtype=ht.float32, device={A.device}, split=0)"
    _require(text == want, f"repr(A) differs from NumPy's summary of the operand's edge items:\n{text}\n{want}")
    repr_ms = _median_ms(lambda: repr(A), INDEXING_REPS)
    rows.append({"name": "repr(A)", "ms": round(repr_ms, 4), "host_bytes": int(block.nbytes), "bound_ms": None,
                 "bound_by": "host", "err": 0, "tol": "the edge items of the operand"})
    print(f"indexing repr(A): {repr_ms:.4f} ms (CUDA events, median of {INDEXING_REPS}), {block.nbytes} bytes copied "
          f"to the host (the 7 x 7 edge block of a 65536 x 8192 float32 array)", flush=True)
    print(f"indexing selections: {n_elements} elements > 2.5, {n_rows} rows with A[:, 0] > 0, {n_low} elements "
          f"< -4.0", flush=True)
    del A, B, a, idx, want
    torch.cuda.empty_cache()
    return {"rows": rows, "launches": {"topk": topk_launches}}


# --------------------------------------------------------------------- #
# data-parallel training and KMedians/KMedoids (no kernel of their own) #
# --------------------------------------------------------------------- #
TRAIN_N, TRAIN_SIDE, TRAIN_CLASSES = 60_000, 28, 10  # MNIST's training set (examples/mnist.py)
TRAIN_BATCH = 8192  # the global batch examples/mnist.py feeds a step
TRAIN_STEPS = 5
TRAIN_LR = 0.05  # examples/mnist.py's SGD
TRAIN_KEY = 18
TRAIN_CHECK_ROWS = 256  # rows of the one step held against the CPU
TOL_TRAIN_CPU = 1e-4
TOL_CONV = 1e-5  # FP32 rounding of a 288-term sum; TF32 misses by about 1e-3
WORLD_TRAIN_STEPS = 3
TOL_WORLD_TRAIN = 1e-4
KMD_ITERS = 10
KMD_WORLD_ITERS = 4
TOL_KMD_CENTERS = 1e-6
WORLD_REFERENCE = {}  # world size 1's results the world is held against (saved beside the workers)
PROFILES = {}  # label -> (wall ms, device busy ms) of profile_breakdown


def _mnist_arrays(seed: int, n: int):
    """MNIST-shaped uint8 images with planted classes: noise below 48, and
    for class c an 8 x 8 patch of 200-255 at one of ten places; labels
    uint8 in [0, 10)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    labels = rng.integers(0, TRAIN_CLASSES, n).astype(np.uint8)
    images = rng.integers(0, 48, (n, TRAIN_SIDE, TRAIN_SIDE), dtype=np.uint8)
    for c in range(TRAIN_CLASSES):
        r0, c0 = 2 + 13 * (c // 5), 5 * (c % 5)
        rows = np.nonzero(labels == c)[0]
        images[rows, r0 : r0 + 8, c0 : c0 + 8] = rng.integers(200, 256, (len(rows), 8, 8), dtype=np.uint8)
    return images, labels


def _write_mnist(root: str) -> None:
    """The training split as IDX files under ``root/MNIST/raw``: images
    plain, labels gzipped (both readers of ``_read_idx``)."""
    import gzip
    import os
    import struct

    images, labels = _mnist_arrays(TRAIN_KEY, TRAIN_N)
    raw = os.path.join(root, "MNIST", "raw")
    os.makedirs(raw, exist_ok=True)
    with open(os.path.join(raw, "train-images-idx3-ubyte"), "wb") as f:
        f.write(struct.pack(">IIII", 0x803, TRAIN_N, TRAIN_SIDE, TRAIN_SIDE) + images.tobytes())
    with gzip.open(os.path.join(raw, "train-labels-idx1-ubyte.gz"), "wb") as f:
        f.write(struct.pack(">II", 0x801, TRAIN_N) + labels.tobytes())


def _cnn(ht, device=None):
    """examples/mnist.py:57-73's ``cnn_net`` (the Heat reference's CNN)."""
    nn = ht.nn
    flat = 64 * ((TRAIN_SIDE - 4) // 2) ** 2
    return nn.Sequential(
        nn.Conv2d(1, 32, 3, device=device), nn.ReLU(), nn.Conv2d(32, 64, 3, device=device), nn.ReLU(),
        nn.MaxPool2d(2), nn.Dropout2d(0.25), nn.Flatten(), nn.Linear(flat, 128, device=device), nn.ReLU(),
        nn.Dropout(0.5), nn.Linear(128, TRAIN_CLASSES, device=device),
    )


def _mlp(ht, device=None):
    """examples/mnist.py's MLP 784 -> 128 -> 10, on the flattened image."""
    nn = ht.nn
    d = TRAIN_SIDE * TRAIN_SIDE
    return nn.Sequential(nn.Flatten(), nn.Linear(d, 128, device=device), nn.ReLU(),
                         nn.Linear(128, TRAIN_CLASSES, device=device))


def _train_cost(model: str, batch: int):
    """(FLOPs, bytes) of one training step: the forward's multiply-adds
    twice, the backward's twice that; the bytes the parameters (read, their
    gradient written, read and written again by SGD) and the batch read
    once."""
    s = TRAIN_SIDE
    if model == "cnn":
        c1, c2 = (s - 2) ** 2 * 32 * 9, (s - 4) ** 2 * 64 * 32 * 9
        fc = 64 * ((s - 4) // 2) ** 2 * 128 + 128 * TRAIN_CLASSES
        macs, params = c1 + c2 + fc, 32 * 9 + 32 + 64 * 32 * 9 + 64 + fc + 128 + TRAIN_CLASSES
    else:
        macs = s * s * 128 + 128 * TRAIN_CLASSES
        params = macs + 128 + TRAIN_CLASSES
    return 6.0 * macs * batch, 4.0 * (5 * params + batch * s * s)


def _params_of(model):
    import torch

    return torch.cat([p.detach().reshape(-1) for p in model.module.parameters()])


def check_conv(dev) -> dict:
    """A float32 ``Conv2d`` at the CNN's second layer (32 -> 64, 3 x 3, on
    (256, 32, 26, 26)), forward and backward on the card against the same
    module on the CPU: within FP32 rounding (``TOL_CONV``, relative), which
    needs cuDNN's TF32 off around the calls; the same forward with TF32 on
    is printed beside it."""
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.core import _threefry as tf

    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    x = torch.randn(TRAIN_CHECK_ROWS, 32, 26, 26, device=dev, generator=gen)
    r = torch.randn(TRAIN_CHECK_ROWS, 64, 24, 24, device=dev, generator=gen)
    out = []
    for where, at in ((None, dev), ("cpu", torch.device("cpu"))):  # the card (the default device), then the CPU
        conv = ht.nn.Conv2d(32, 64, 3, device=where, key=tf.seed_key(19))
        xi = x.to(at, copy=True).requires_grad_()
        y = conv(xi)
        (y * r.to(at)).sum().backward()
        out.append([t.detach().cpu() for t in (y, conv.weight.grad, conv.bias.grad, xi.grad)])
    errs = [_rel(a, b) for a, b in zip(*out)]
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        conv = ht.nn.Conv2d(32, 64, 3, key=tf.seed_key(19))
        tf32 = _rel(torch.nn.functional.conv2d(x, conv.weight.detach(), conv.bias.detach()).cpu(), out[1][0])
    finally:
        torch.backends.cudnn.allow_tf32 = was
    print(
        f"Conv2d(32, 64, 3) float32 on (256, 32, 26, 26): card against CPU, relative: forward {errs[0]:.3e}, "
        f"weight grad {errs[1]:.3e}, bias grad {errs[2]:.3e}, input grad {errs[3]:.3e} (tol {TOL_CONV}, cuDNN TF32 "
        f"off inside the module; the process-wide switch is {torch.backends.cudnn.allow_tf32}); the same forward "
        f"with TF32 on: {tf32:.3e}", flush=True,
    )
    _require(max(errs) <= TOL_CONV, "a float32 Conv2d on the card is not within FP32 rounding of the CPU's")
    _require(torch.backends.cudnn.allow_tf32 == was, "Conv2d changed the process-wide TF32 switch")
    return {"errs": errs, "tf32_err": tf32}


def _train_steps(ht, opt, batches, label: str, dropouts: int):
    """``opt.step`` over ``batches``; each step must launch R1 once a
    dropout layer (its rows of the global mask). Returns the losses and
    R1's launches in each step."""
    import torch

    from heat_tpu_torch.kernels import threefry as kt

    losses, launches = [], []
    for i, (xb, yb) in enumerate(batches):
        _r1_zero()
        loss = opt.step(xb, yb)
        torch.cuda.synchronize()
        launches.append(kt.THREEFRY_LAUNCHES)
        _require(kt.THREEFRY_LAUNCHES == dropouts, f"{label} step {i}: R1 launched {kt.THREEFRY_LAUNCHES} times, "
                 f"not once for each of its {dropouts} dropout layers")
        losses.append(float(loss))
    return losses, launches


def train_path(dev) -> dict:
    """BASELINE #5's training through the public entry points: MNIST-shaped
    IDX files written and read back by ``MNISTDataset``, a shuffled
    ``DataLoader`` of global batches of 8192, and ``TRAIN_STEPS`` SGD steps
    of examples/mnist.py's CNN and MLP through ``DataParallel`` and
    ``DataParallelOptimizer``; one step on 256 rows held against the same
    model and key on the CPU; times per step beside the bound, and the
    card's busy share."""
    import shutil
    import tempfile

    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.kernels import sort as ks
    from heat_tpu_torch.kernels import threefry as kt

    res = {"conv": check_conv(dev)}
    root = tempfile.mkdtemp(prefix="heat_mnist_")
    try:
        t0 = time.perf_counter()
        _write_mnist(root)
        ds = ht.utils.data.MNISTDataset(root, train=True, transform=lambda a: a[:, None])
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _require(ds.htdata.shape == (TRAIN_N, 1, TRAIN_SIDE, TRAIN_SIDE) and ds.htdata.larray.is_cuda,
             "MNISTDataset: images not (60000, 1, 28, 28) on the card")
    ht.random.seed(TRAIN_KEY)
    loader = ht.utils.data.DataLoader(ds, batch_size=TRAIN_BATCH, shuffle=True)
    _r1_zero()
    ks.SORT_LAUNCHES = 0
    it = iter(loader)
    batches = [next(it) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    res["shuffle"] = {"r1": kt.THREEFRY_LAUNCHES, "k4": ks.SORT_LAUNCHES}
    _require(kt.THREEFRY_LAUNCHES >= 1, "the shuffle drew no permutation through R1")
    labels = torch.cat([b[1].larray for b in batches])
    _require(len(batches) == TRAIN_STEPS and batches[0][0].shape == (TRAIN_BATCH, 1, TRAIN_SIDE, TRAIN_SIDE)
             and int(labels.min()) >= 0 and int(labels.max()) < TRAIN_CLASSES, "the loader's batches")
    print(f"MNIST: {TRAIN_N} planted 28 x 28 images written as IDX and read by MNISTDataset in {load_s:.2f} s; the "
          f"shuffle launched R1 {res['shuffle']['r1']} and K4 {res['shuffle']['k4']} times", flush=True)

    for name, build, dropouts in (("cnn", _cnn, 2), ("mlp", _mlp, 0)):
        model = ht.nn.DataParallel(build(ht), key=TRAIN_KEY)
        opt = ht.optim.DataParallelOptimizer(ht.optim.SGD(lr=TRAIN_LR), model)
        losses, r1_steps = _train_steps(ht, opt, batches, name, dropouts)
        _require(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
                 f"{name}: the loss did not fall over {TRAIN_STEPS} steps: {losses}")
        xb, yb = batches[0]
        step_ms = _median_ms(lambda: opt.step(xb, yb), 5)
        profile_breakdown(f"{name} training step", lambda: opt.step(xb, yb))
        wall, busy = PROFILES[f"{name} training step"]
        flops, nbytes = _train_cost(name, TRAIN_BATCH)
        bound_ms, bound_by = _bound(nbytes, flops)

        # one step on the batch's first rows, the card against the CPU
        twins = []
        for where, at in ((None, dev), ("cpu", "cpu")):  # the card (the default device), then the CPU
            twin = ht.nn.DataParallel(build(ht, where), key=TRAIN_KEY + 1)
            topt = ht.optim.DataParallelOptimizer(ht.optim.SGD(lr=TRAIN_LR), twin)
            x = ht.array(xb.larray[:TRAIN_CHECK_ROWS].to(at), device=where)
            y = ht.array(yb.larray[:TRAIN_CHECK_ROWS].to(at), device=where)
            topt.step(x, y)
            twins.append([p.detach().cpu() for p in twin.module.parameters()])
        cpu_err = max(_rel(a, b) for a, b in zip(*twins))
        res[name] = {"losses": losses, "ms": step_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "busy": busy / wall, "wall_ms": wall, "busy_ms": busy, "cpu_err": cpu_err,
                     "r1_per_step": r1_steps, "gflop": flops / 1e9}
        print(
            f"train {name}: {TRAIN_STEPS} SGD steps of {TRAIN_BATCH}, losses {[round(v, 4) for v in losses]}; "
            f"{step_ms:.4f} ms a step (median of 5, CUDA events), bound {bound_ms:.4f} ms ({bound_by}: "
            f"{flops / 1e12:.4f} TFLOP at FP32's 67 TFLOP/s, {nbytes / 1e9:.3f} GB); card busy "
            f"{busy / wall:.1%} of a profiled step; R1 launches in each step {r1_steps}; one step on "
            f"{TRAIN_CHECK_ROWS} rows, card against CPU: largest relative parameter error {cpu_err:.3e} "
            f"(tol {TOL_TRAIN_CPU})", flush=True,
        )
        _require(cpu_err <= TOL_TRAIN_CPU, f"{name}: a step on the card differs from the CPU's")
        del model, opt

    # world size 1's three steps on the world's batch, which the world is held against
    images, labels_np = _mnist_arrays(TRAIN_KEY, TRAIN_BATCH)
    x = ht.array(images[:, None].astype("float32") / 255.0, split=0)
    y = ht.array(labels_np.astype("int32"), split=0)
    model = ht.nn.DataParallel(_cnn(ht), key=TRAIN_KEY)
    opt = ht.optim.DataParallelOptimizer(ht.optim.SGD(lr=TRAIN_LR), model)
    for _ in range(WORLD_TRAIN_STEPS):
        opt.step(x, y)
    WORLD_REFERENCE["train"] = _params_of(model).cpu()
    del ds, loader, batches, model, opt, x, y
    torch.cuda.empty_cache()
    return res


def _kmd_fit(ht, est: str, X, **kw):
    cls = getattr(ht.cluster, est)
    return cls(n_clusters=KM_K, **kw).fit(X)


def check_cluster_medians(x, centers) -> dict:
    """The cross-rank median at the full shard, held against plain torch:
    K4's pair sort of the 10^9 (segment, word) pairs, called as
    ``_segment_counter`` calls it, must be nondecreasing in the (segment,
    word) composite and a permutation of its input (each segment's count,
    word sum and sum of the squared low 16 bits, in int64); and
    ``_cluster_medians`` must equal, bit for bit, the plain formula: for
    each column ``torch.sort`` of the values, a stable ``torch.sort`` of
    their labels, the order statistics (C - 1) // 2 and C // 2 of each
    cluster's run and the same interpolation; its row counts
    ``torch.bincount``'s."""
    import torch

    from heat_tpu_torch.cluster import _kcluster
    from heat_tpu_torch.kernels import sort as ks

    n, f = x.shape
    lab = _kcluster._l1_assign(x, centers)
    words = ks.to_sortable(x).reshape(-1)
    seg = (lab[:, None].to(torch.int32) + torch.arange(f, dtype=torch.int32, device=x.device) * KM_K).reshape(-1)
    sk, sp = ks.pair_sort(seg, words, pay_bytes=4)
    chunk = 1 << 27
    ordered = True
    sums = torch.zeros(2, 3, KM_K * f, dtype=torch.int64, device=x.device)
    for s in range(0, seg.numel(), chunk):
        e = min(s + chunk + 1, seg.numel())  # one pair of overlap joins the chunks
        comp = (sk[s:e].to(torch.int64) << 32) | (sp[s:e].to(torch.int64) & 0xFFFFFFFF)
        ordered = ordered and bool((comp[1:] >= comp[:-1]).all())
        e = min(s + chunk, seg.numel())
        for side, (g, w) in enumerate(((seg[s:e], words[s:e]), (sk[s:e], sp[s:e]))):
            g, w = g.to(torch.int64), w.to(torch.int64)
            low = w & 0xFFFF
            sums[side].index_add_(1, g, torch.stack([torch.ones_like(w), w, low * low]))
    del comp, g, w, low, words, seg, sk, sp
    permuted = torch.equal(sums[0], sums[1])
    print(f"K4 under the median, {n * f} (segment, word) pairs: nondecreasing in (segment, word) {ordered}; a "
          f"permutation of its input (count, sum, squares of each segment) {permuted}", flush=True)
    _require(ordered and permuted, "K4's pair sort under the cross-rank median is not a sorted permutation")

    med, sizes = _kcluster._cluster_medians(x, lab, KM_K, _kcluster._Rows(None, [n]))
    counts = torch.bincount(lab, minlength=KM_K)
    start = torch.cumsum(counts, 0) - counts
    at = torch.stack([start + (counts - 1).clamp_min(0) // 2, start + counts // 2], dim=-1).clamp_max(n - 1)
    values = torch.empty(KM_K, f, 2, dtype=x.dtype, device=x.device)
    for j in range(f):
        v, order = torch.sort(x[:, j], stable=True)
        v = v[torch.sort(lab[order], stable=True).indices]
        values[:, j] = v[at]
    c = counts[:, None].expand(KM_K, f)
    q = 0.5 * (c.to(x.dtype) - 1)
    w_hi = q - torch.floor(q)
    ref = values[..., 0] * (1 - w_hi) + values[..., 1] * w_hi
    ref = torch.where(c > 0, ref, torch.full_like(ref, float("nan")))
    same = (med.view(torch.int32) == ref.view(torch.int32)) | (torch.isnan(med) & torch.isnan(ref))
    bits = int((~same).sum())
    print(f"_cluster_medians at {n} x {f}, k = {KM_K}: {bits} of {KM_K * f} medians differ in any bit from the "
          f"plain sort's; row counts equal bincount's {torch.equal(sizes, counts)}", flush=True)
    _require(bits == 0 and torch.equal(sizes, counts), "the cross-rank median differs from the plain sort's")
    return {"pairs": n * f, "sorted": ordered, "permutation": permuted, "median_bits_differ": bits}


def kmedians_path(dev) -> dict:
    """KMedians and KMedoids on BASELINE #4's per-chip shard
    (``ht.random.randn(15_625_000, 64, split=0)``, k = 8, ++ seeding,
    ``KMD_ITERS`` iterations): K4 once an iteration (the cross-rank
    median's one sort), R1 k times (the seeding); ms per iteration; planted
    blobs of the same size recovered; then ``KMD_WORLD_ITERS`` iterations
    from ``init="random"``, kept for the world."""
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.cluster import _kcluster, kmedians, kmedoids
    from heat_tpu_torch.cluster._kcluster import make_fit_loop
    from heat_tpu_torch.kernels import sort as ks

    ht.random.seed(0)
    _r1_zero()
    X = ht.random.randn(KM_N, KM_D, split=0)
    torch.cuda.synchronize()
    _r1_read("kmedians_draw", 1, [KM_N * KM_D])
    res = {}
    steps = {"KMedians": kmedians._median_step, "KMedoids": kmedoids._medoid_step}
    for est, step in steps.items():
        kw = {"tol": -1.0} if est == "KMedians" else {}
        ks.SORT_LAUNCHES = 0
        _r1_zero()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        km = _kmd_fit(ht, est, X, init="probability_based", max_iter=KMD_ITERS, random_state=0, **kw)
        stop.record()
        torch.cuda.synchronize()
        fit_ms = start.elapsed_time(stop)
        _r1_read(f"{est.lower()}_fit", KM_K, [1] + [2 + int(math.log(KM_K))] * (KM_K - 1))
        k4 = ks.SORT_LAUNCHES
        _require(k4 == km.n_iter_ and km.n_iter_ >= 1, f"{est}: K4 launched {k4} times in {km.n_iter_} iterations")
        centers, labels = km.cluster_centers_.larray, km.labels_.larray
        _require(bool(torch.isfinite(centers).all()) and int(labels.min()) >= 0 and int(labels.max()) < KM_K,
                 f"{est}: centers or labels out of range")
        loop = make_fit_loop(step, -1.0, KMD_ITERS, False)
        loop(X.larray, centers)  # warm
        t = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ks.SORT_LAUNCHES = 0
        t[0].record()
        loop(X.larray, centers)
        t[1].record()
        torch.cuda.synchronize()
        per_iter = t[0].elapsed_time(t[1]) / KMD_ITERS
        _require(ks.SORT_LAUNCHES == KMD_ITERS, f"{est}: K4 not once an iteration in the timed loop")
        # bound: X read once and the (segment, value) pairs sorted once: 8 bytes a pair in, 8 out
        nbytes = 4.0 * KM_N * KM_D + 16.0 * KM_N * KM_D
        bound_ms, bound_by = _bound(nbytes, 3.0 * KM_N * KM_K * KM_D)
        profile_breakdown(f"{est} step", lambda: step(X.larray, centers))
        res[est] = {"n_iter": km.n_iter_, "k4": k4, "fit_ms": fit_ms, "iter_ms": per_iter, "bound_ms": bound_ms,
                    "bound_by": bound_by}
        if est == "KMedians":  # where a step's time goes, each part alone (CUDA events, median of 3)
            x = X.larray
            lab = _kcluster._l1_assign(x, centers)
            res["step_parts_ms"] = {
                "l1_assign (torch.cdist p=1)": _median_ms(lambda: _kcluster._l1_assign(x, centers), 3),
                "to_sortable": _median_ms(lambda: ks.to_sortable(x), 3),
                "sort and composite (K4 once)": _median_ms(lambda: _kcluster._segment_counter(x, lab, KM_K), 3),
                "cluster_medians (the sort and 17 counting rounds)": _median_ms(
                    lambda: _kcluster._cluster_medians(x, lab, KM_K, _kcluster._Rows(None, [KM_N])), 3),
            }
            print(f"KMedians step parts alone: {res['step_parts_ms']}", flush=True)
            del lab
            res["check"] = check_cluster_medians(x, centers)
        print(
            f"{est}({KM_N}x{KM_D}, k={KM_K}, ++ seeding).fit: n_iter {km.n_iter_}, {fit_ms:.4f} ms (one fit, CUDA "
            f"events); {per_iter:.4f} ms an iteration ({KMD_ITERS} timed), bound {bound_ms:.4f} ms ({bound_by}: X "
            f"read once, its {KM_N * KM_D} (segment, value) pairs sorted once); K4 launches {k4} (= n_iter), R1 {KM_K} "
            f"(seeding)", flush=True,
        )
        del km, centers, labels

    # the world's reference: the same draw from init="random" (K4 also sorts under its permutation)
    WORLD_REFERENCE["kmedians"] = {}
    for est in steps:
        kw = {"tol": -1.0} if est == "KMedians" else {}
        ks.SORT_LAUNCHES = 0
        km = _kmd_fit(ht, est, X, init="random", max_iter=KMD_WORLD_ITERS, random_state=3, **kw)
        WORLD_REFERENCE["kmedians"][est] = (km.labels_.larray.to(torch.int8).cpu(), km.cluster_centers_.larray.cpu(),
                                            km.n_iter_, ks.SORT_LAUNCHES)
    del X
    torch.cuda.empty_cache()

    # eight planted blobs of the same size
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    x = _blobs(gen, KM_N, torch.randn(KM_K, KM_D, device=dev, generator=gen) * 8.0)
    B = ht.array(x, split=0)
    for est in steps:
        km = _kmd_fit(ht, est, B, init="probability_based", random_state=1)
        ok = _recovered(km.labels_.larray, KM_K)
        print(f"blobs, {est} ++: n_iter {km.n_iter_}, every blob one distinct cluster: {ok}", flush=True)
        _require(ok, f"{est} did not recover the eight blobs")
        res[est]["blob_iter"] = km.n_iter_
    del x, B, km
    torch.cuda.empty_cache()
    return res


def _world_train(ht, comm, moved: dict, rank: int, dev) -> dict:
    """examples/mnist.py's CNN on the global batch of 8192 split over the
    ranks: ``WORLD_TRAIN_STEPS`` SGD steps, after which every rank's
    parameters must be equal bit for bit and within ``TOL_WORLD_TRAIN`` of
    world size 1's; then DASO with two nodes of two ranks (global_skip 2,
    bfloat16 wire): after its first step the ranks of a node equal and the
    nodes apart, after its second (a global sync) all equal."""
    import torch

    images, labels = _mnist_arrays(TRAIN_KEY, TRAIN_BATCH)
    x = ht.array(images[:, None].astype("float32") / 255.0, split=0)
    y = ht.array(labels.astype("int32"), split=0)
    model = ht.nn.DataParallel(_cnn(ht), key=TRAIN_KEY)
    opt = ht.optim.DataParallelOptimizer(ht.optim.SGD(lr=TRAIN_LR), model)
    comm.counts.clear()
    moved.clear()
    for _ in range(WORLD_TRAIN_STEPS):
        opt.step(x, y)
    torch.cuda.synchronize()
    counts, nbytes = dict(comm.counts), dict(moved)
    mine = _params_of(model)
    every = comm.allgather(mine[None])
    same = all(torch.equal(every[q], every[0]) for q in range(WORLD))
    ref = WORLD_REFERENCE["train"].to(dev)
    err = _rel(mine, ref)
    _every_rank_ok(comm, same and err <= TOL_WORLD_TRAIN, f"DP training across ranks: parameters equal on every "
                   f"rank {same}, against world size 1 {err:.3e} (tol {TOL_WORLD_TRAIN})")
    step_ms = _world_ms(lambda: opt.step(x, y), 3)

    model = ht.nn.DataParallel(_cnn(ht), key=TRAIN_KEY)
    daso = ht.optim.DASO(ht.optim.SGD(lr=TRAIN_LR), model, n_nodes=2, global_skip=2)
    agree = []
    for _ in range(2):
        daso.step(x, y)
        every = comm.allgather(_params_of(model)[None])
        agree.append([[bool(torch.equal(every[a], every[b])) for b in range(WORLD)] for a in range(WORLD)])
    node = [[a // 2 == b // 2 for b in range(WORLD)] for a in range(WORLD)]
    _every_rank_ok(comm, agree[0] == node and all(all(row) for row in agree[1]),
                   f"DASO: after step 1 equal within a node only, after step 2 all equal; got {agree}")
    comm.counts.clear()
    moved.clear()
    daso_ms = _world_ms(lambda: daso.step(x, y), 4)
    return {"counts": counts, "bytes": nbytes, "err": err, "ms": step_ms, "daso_ms": daso_ms,
            "daso_counts": dict(comm.counts), "daso_bytes": dict(moved)}


def _world_kmedians(ht, comm, moved: dict, rank: int, dev) -> dict:
    """KMedians and KMedoids on the same global draw as world size 1
    (``ht.random.randn(15_625_000, 64, split=0)`` after ``seed(0)``, each
    rank its chunk) from ``init="random"``: each rank's labels equal to
    world size 1's rows, the centers within ``TOL_KMD_CENTERS``, the same
    ``n_iter_``, and K4 launched as often as at world size 1 (once an
    iteration, and under the permutation of the init, which every rank
    computes whole)."""
    import torch

    from heat_tpu_torch.kernels import sort as ks

    ht.random.seed(0)
    X = ht.random.randn(KM_N, KM_D, split=0)
    counts_r, displs = X.counts_displs()
    out = {}
    for est, (labels, centers, n_iter, k4_ref) in WORLD_REFERENCE["kmedians"].items():
        kw = {"tol": -1.0} if est == "KMedians" else {}
        ks.SORT_LAUNCHES = 0
        comm.counts.clear()
        moved.clear()
        km = _kmd_fit(ht, est, X, init="random", max_iter=KMD_WORLD_ITERS, random_state=3, **kw)
        torch.cuda.synchronize()
        k4, counts, nbytes = ks.SORT_LAUNCHES, dict(comm.counts), dict(moved)
        mine = labels[displs[rank] : displs[rank] + counts_r[rank]].to(dev, torch.int64)
        same = torch.equal(km.labels_.larray, mine)
        err = _rel(km.cluster_centers_.larray, centers.to(dev))
        _every_rank_ok(comm, same and err <= TOL_KMD_CENTERS and km.n_iter_ == n_iter and k4 == k4_ref,
                       f"{est} across ranks: labels equal {same}, centers rel {err:.3e}, n_iter {km.n_iter_} "
                       f"against {n_iter}, K4 launches {k4} against {k4_ref}")
        fit_ms = _world_ms(lambda: _kmd_fit(ht, est, X, init="random", max_iter=KMD_WORLD_ITERS, random_state=3,
                                            **kw), 2)
        out[est] = {"k4": k4, "k4_init": k4 - n_iter, "counts": counts, "bytes": nbytes, "err": err, "ms": fit_ms,
                    "n_iter": n_iter}
    del X
    return out


# --------------------------------------------------------------------- #
# manipulations, halos, convolve and the gallery (no kernel of their own) #
# --------------------------------------------------------------------- #
MANIP_SEED = 19  # the seed of the manipulation phase's draws
MANIP_REPS = 5
CONCAT_HARNESS = ((1000, 10_000, 1), (1000, 20_000, None), (1000, 40_000, 1))  # bench.py:990-995
CONV_N, CONV_K = 1 << 29, 129  # float32 samples, taps (mode same)
CONV_CPU_N = 1 << 20  # the slice held against the CPU's convolve
TOL_CONV = 1e-5  # of max(|a| * |v|), the convolution of the magnitudes
GALLERY = (1000, 500, 10)  # BASELINE's hsvd_rank harness at P = 1: 1000 x 500·P, rank 10, split 1
TOL_GALLERY = 1e-4  # of the largest singular value
WORLD_MANIP_ROWS = 16384  # rows of the world's operand a rank (x 8192 float32 columns)
WORLD_MANIP_SEED = 9300
WORLD_CONV_N = 1 << 27  # samples a rank


def _conv_scale(x, v):
    """max of the convolution of |x| and |v|, the scale of convolve's error."""
    import torch

    return float(torch.nn.functional.conv1d(x.abs().view(1, 1, -1), v.abs().flip(0).view(1, 1, -1),
                                            padding=v.shape[0] - 1).max())


def _conv_ref(x, v, left: int, right: int, dtype):
    """The plain convolution on the card: zeros around x, one conv1d in
    ``dtype`` with TF32 off."""
    import torch

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ext = torch.nn.functional.pad(x.to(dtype), (left, right))
        return torch.nn.functional.conv1d(ext.view(1, 1, -1), v.to(dtype).flip(0).view(1, 1, -1)).view(-1)
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def manip_path(dev) -> dict:
    """The manipulations on the card at world size 1: BASELINE's
    ``concatenate`` harness (three float32 arrays of 1000 x 10,000, 20,000
    and 40,000, split 1, None, 1, along axis 1), then on the north-star
    operand A (``ht.random.randn(65536, 8192, split=0)``) ``concatenate([A,
    A], 0)``, ``stack``, ``pad``, ``roll``, ``repeat``, ``tile``,
    ``swapaxes`` (a copy), ``split`` and ``flatten`` (views), ``diagonal``,
    ``get_halo``/``array_with_halos``, each equal bit for bit to its torch
    formula and timed under CUDA events beside its byte bound (what it must
    read once and write once over 3.35 TB/s); ``convolve`` of 2^29 float32
    samples with 129 taps, mode same, against the plain conv1d in float64
    on the card and against the CPU's ``convolve`` on a 2^20 slice (1e-5 of
    the magnitudes' convolution; TF32 would miss it), timed beside its
    operation bound (2·n·k FLOP at 67 TFLOP/s); the gallery's
    ``random_known_rank(1000, 500, 10, split=1)`` (R1) and ``hsvd_rank`` of
    it, its 10 σ within 1e-4. Returns the rows and the launches of K1, K2,
    K5, K6 and R1 on the path."""
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.core.linalg import _cuda_sketch as cs
    from heat_tpu_torch.kernels import relayout as kr
    from heat_tpu_torch.utils.data import matrixgallery

    kr.PACK_LAUNCHES = kr.UNPACK_LAUNCHES = 0
    ht.random.seed(MANIP_SEED)
    _r1_zero()
    parts = [ht.random.randn(m, n, split=s) for m, n, s in CONCAT_HARNESS]
    A = ht.random.randn(M, N, split=0)
    torch.cuda.synchronize()
    r1 = {"manip_draw": _r1_read("manip_draw", 4, [m * n for m, n, _ in CONCAT_HARNESS] + [M * N])["launches"]}
    a = A.larray
    _require(a.device == dev and A.dtype is ht.float32 and A.split == 0, "the manipulation operand is not on the card")
    rows = []

    def record(label: str, call, nbytes: float, ok, flops: float = 0.0, tol_text: str = "bit for bit",
               reps: int = MANIP_REPS, extra: dict = None):
        out = call()
        torch.cuda.synchronize()
        err = ok(out)
        del out
        ms = _median_ms(call, reps)
        bound, by = _bound(nbytes, flops)
        rows.append({"name": label, "ms": round(ms, 4), "bound_ms": round(bound, 6), "bound_by": by,
                     "bytes": nbytes, "flops": flops, "err": err, "tol": tol_text, **(extra or {})})
        print(f"manip {label}: {ms:.4f} ms (CUDA events, median of {reps}), bound {bound:.6f} ms ({by}: "
              f"{nbytes / 1e9:.6f} GB over 3.35 TB/s, {flops / 1e9:.3f} GFLOP over 67 TFLOP/s); against its torch "
              f"formula: {tol_text}, {'equal' if err == 0 else format(err, '.3e') + ' of its limit'}"
              + (f"; {extra}" if extra else ""), flush=True)
        _require(err is not None and (err == 0 if tol_text == "bit for bit" else err <= 1.0),
                 f"manip {label} disagrees with its torch formula ({err} against {tol_text})")

    def exact(ref, split):  # values, split, and a map that holds the one shard (world size 1)
        return lambda o: 0 if o.split == split and tuple(o.larray.shape) == tuple(ref.shape) and \
            o.lshape_map.tolist() == [list(ref.shape)] and o.is_balanced() and torch.equal(o.larray, ref) else 1

    def views(ref, split):  # the same values, and a view of A's memory
        return lambda o: exact(ref, split)(o) or int(o.larray.data_ptr() != ref.data_ptr())

    gb = 4.0 * M * N
    ref = torch.cat([p.larray for p in parts], 1)
    record("concatenate(harness, 1): 1000x10000 split 1, 1000x20000 whole, 1000x40000 split 1",
           lambda: ht.concatenate(parts, 1), 2 * 4.0 * ref.numel(), exact(ref, 1))
    del ref, parts
    ref = torch.cat([a, a])
    record("concatenate([A, A], 0)", lambda: ht.concatenate([A, A], 0), 2 * 2 * gb, exact(ref, 0))
    del ref
    ref = torch.stack([a, a])
    record("stack([A, A])", lambda: ht.stack([A, A]), 2 * 2 * gb, exact(ref, 1))
    del ref
    torch.cuda.empty_cache()
    ref = torch.nn.functional.pad(a, (2, 2, 1, 1))
    record("pad(A, ((1, 1), (2, 2)))", lambda: ht.pad(A, ((1, 1), (2, 2))), gb + 4.0 * ref.numel(), exact(ref, 0))
    del ref
    ref = torch.roll(a, 1000, 0)
    record("roll(A, 1000, 0)", lambda: ht.roll(A, 1000, 0), 2 * gb, exact(ref, 0))
    del ref
    ref = torch.repeat_interleave(a, 2, 0)
    record("repeat(A, 2, 0)", lambda: ht.repeat(A, 2, 0), 3 * gb, exact(ref, 0))
    del ref
    ref = a.repeat(2, 1)
    record("tile(A, (2, 1))", lambda: ht.tile(A, (2, 1)), 3 * gb, exact(ref, 0))
    del ref
    torch.cuda.empty_cache()
    ref = a.T.contiguous()
    record("swapaxes(A, 0, 1) (a copy)", lambda: ht.swapaxes(A, 0, 1), 2 * gb, exact(ref, 1))
    del ref
    q = M // 4
    record("split(A, 4, 0) (views)", lambda: ht.split(A, 4, 0), 0.0,
           lambda o: sum(views(a[i * q: (i + 1) * q], 0)(p) for i, p in enumerate(o)))
    record("diagonal(A)", lambda: ht.diagonal(A), 2 * 4.0 * N, exact(torch.diagonal(a).clone(), 0))
    record("flatten(A) (a view)", lambda: ht.flatten(A), 0.0, views(a.reshape(-1), 0))

    def halos():
        A.get_halo(2)
        return A
    record("get_halo(2), array_with_halos (one rank: no neighbour)", halos, 0.0,
           lambda o: int(o.halo_prev is not None or o.halo_next is not None or o.array_with_halos is not a))

    # convolve: 2^29 samples, 129 taps, mode same
    del A, a
    torch.cuda.empty_cache()
    _r1_zero()
    X = ht.random.randn(CONV_N, split=0)
    v = ht.random.randn(CONV_K)
    torch.cuda.synchronize()
    r1["convolve_draw"] = _r1_read("convolve_draw", 2, [CONV_N, CONV_K])["launches"]
    x, w = X.larray, v.larray
    left, right = CONV_K // 2, CONV_K - 1 - CONV_K // 2
    scale = _conv_scale(x, w)
    ref = _conv_ref(x, w, left, right, torch.float64)
    _require(torch.backends.cudnn.allow_tf32, "cuDNN's TF32 switch is off before convolve (it is on by default)")
    ops = 2.0 * CONV_N * CONV_K
    plain_ms = _median_ms(lambda: _conv_ref(x, w, left, right, torch.float32), MANIP_REPS)
    record(f"convolve(randn({CONV_N}), randn({CONV_K}), 'same')", lambda: ht.convolve(X, v, "same"), 2 * 4.0 * CONV_N,
           lambda o: float((o.larray.double() - ref).abs().max()) / (TOL_CONV * scale)
           if o.split == 0 and o.shape == (CONV_N,) and o.lshape_map.tolist() == [[CONV_N]] else 2.0, flops=ops,
           tol_text=f"within {TOL_CONV} of max(|a| * |v|) = {scale:.3f} of the float64 conv1d on the card",
           extra={"plain_ms": round(plain_ms, 4), "plain": "conv1d of the padded signal in float32, TF32 off"})
    _require(torch.backends.cudnn.allow_tf32, "convolve left cuDNN's TF32 switch off")
    del ref
    torch.cuda.empty_cache()
    xs, ws = x[:CONV_CPU_N].clone(), w.clone()
    card = ht.convolve(ht.array(xs), ht.array(ws), "same").larray.double().cpu()
    host = ht.convolve(ht.array(xs.cpu(), device="cpu"), ht.array(ws.cpu(), device="cpu"), "same").larray.double()
    cpu_err = float((card - host).abs().max()) / (TOL_CONV * _conv_scale(xs, ws))
    print(f"manip convolve on {CONV_CPU_N} samples: card against the CPU {cpu_err:.3e} of its limit "
          f"({TOL_CONV} of max(|a| * |v|))", flush=True)
    _require(cpu_err <= 1.0, f"convolve on the card differs from the CPU's ({cpu_err:.3e} of its limit)")
    rows[-1]["cpu_err"] = cpu_err
    del X, v, x, w, xs, ws, card, host
    torch.cuda.empty_cache()

    # the gallery at BASELINE's hsvd_rank harness shape, then hsvd_rank
    m, n, r = GALLERY
    ht.random.seed(MANIP_SEED + 1)
    _r1_zero()
    G, (_, s, _) = matrixgallery.random_known_rank(m, n, r, split=1)
    torch.cuda.synchronize()
    r1["gallery_draw"] = _r1_read("gallery_draw", 3, [r, m * r, n * r])["launches"]
    cs.SKETCH_LAUNCHES = cs.DUAL_LAUNCHES = cs.SKETCH_SM90_LAUNCHES = cs.DUAL_SM90_LAUNCHES = 0
    _r1_zero()
    U, sigma, V, err = ht.linalg.hsvd_rank(G, r, compute_sv=True)
    torch.cuda.synchronize()
    r1["gallery_hsvd"] = _r1_read("gallery_hsvd", 1)["launches"]
    want = torch.sort(s.larray, descending=True).values
    sig_err = float((sigma.larray - want).abs().max() / want[0])
    k1 = {"sketch_with_norm": cs.SKETCH_LAUNCHES, "sketch_sm90": cs.SKETCH_SM90_LAUNCHES,
          "dual_sketch_with_norm": cs.DUAL_LAUNCHES}
    print(f"manip gallery: random_known_rank({m}, {n}, {r}, split=1) {tuple(G.shape)} split {G.split}, then "
          f"hsvd_rank(G, {r}): sigma {[round(float(t), 6) for t in sigma.larray]} against "
          f"{[round(float(t), 6) for t in want]}, max |Δσ| / σ_max {sig_err:.3e} (tol {TOL_GALLERY}); K1/K2 launches "
          f"{k1}; R1 {r1['gallery_draw']} (draw), {r1['gallery_hsvd']} (hsvd)", flush=True)
    _require(G.split == 1 and sig_err <= TOL_GALLERY, f"the gallery's singular values came back off ({sig_err:.3e})")
    del G, U, V, sigma
    launches = {"k1": k1, "k5": kr.PACK_LAUNCHES, "k6": kr.UNPACK_LAUNCHES, "r1": r1}
    print(f"manip launches: {launches} (K5/K6: no resplit on one rank)", flush=True)
    torch.cuda.empty_cache()
    return {"rows": rows, "launches": launches, "gallery_sigma_err": sig_err}


def _world_manip(ht, comm, moved: dict, rank: int, dev) -> dict:
    """Manipulations across ranks on a 65536 x 8192 float32 operand split 0
    (16384 rows a rank), each rank's shard made on the card from a seed
    every rank shares: the ``concatenate`` harness with its mixed splits,
    ``concatenate([A, A], 0)``, ``pad``, ``roll``, ``repeat``, ``tile``
    along the split axis, ``balance`` of an uneven slice, ``collect``,
    ``get_halo`` and ``convolve`` (2^29 samples over the ranks, 129 taps,
    mode same), and the gallery at P = 4 with its ``hsvd_rank``. Each rank
    checks its rows against the torch formula on the whole operand (what
    world size 1 computes): bit for bit for the moves, convolve within
    1e-5 of the magnitudes' convolution."""
    import torch

    from heat_tpu_torch.utils.data import matrixgallery

    gen = torch.Generator(device=dev)
    gen.manual_seed(WORLD_MANIP_SEED)
    rows_total = WORLD * WORLD_MANIP_ROWS
    full = torch.randn(rows_total, N, device=dev, generator=gen)
    r0, c0 = comm.chunk((rows_total, N), 0)[0], rank * WORLD_MANIP_ROWS
    A = ht.array(full[r0: r0 + WORLD_MANIP_ROWS].clone(), is_split=0)
    out = {}

    def counted(call):
        comm.counts.clear()
        moved.clear()
        comm.staged_bytes = 0
        res = call()
        torch.cuda.synchronize()
        return res, {"counts": dict(comm.counts), "bytes": dict(moved), "staged": comm.staged_bytes}

    def mine(res, ref):  # this rank's rows of the global ``ref`` in ``res``'s layout
        split = res.split
        st = int(res.lshape_map[:rank, split].sum())
        return ref.narrow(split, st, int(res.lshape_map[rank, split]))

    def check(name, call, want, reps=2):
        res, info = counted(call)
        ref = want()
        ok = res.gshape == tuple(ref.shape) and torch.equal(res.larray, mine(res, ref))
        _every_rank_ok(comm, ok, f"world {name} differs from the torch formula's rows on rank {rank}")
        out[name] = {**info, "ms": _world_ms(call, reps), "reps": reps,
                     "lshape_map": res.lshape_map[:, res.split].tolist()}
        del res, ref

    harness = []
    for m, n, s in CONCAT_HARNESS:
        whole = torch.randn(m, n, device=dev, generator=gen)
        if s is None:
            harness.append((whole, ht.array(whole)))
        else:
            st, ls, _ = comm.chunk((m, n), s)
            harness.append((whole, ht.array(whole.narrow(s, st, ls[s]).clone(), is_split=s)))
    check("concat_harness", lambda: ht.concatenate([h for _, h in harness], 1),
          lambda: torch.cat([w for w, _ in harness], 1))
    del harness
    check("concat_split0", lambda: ht.concatenate([A, A], 0), lambda: torch.cat([full, full]), reps=1)
    check("pad_split0", lambda: ht.pad(A, ((1, 1), (2, 2))), lambda: torch.nn.functional.pad(full, (2, 2, 1, 1)))
    check("roll_split0", lambda: ht.roll(A, 1000, 0), lambda: torch.roll(full, 1000, 0))
    check("repeat_split0", lambda: ht.repeat(A, 2, 0), lambda: torch.repeat_interleave(full, 2, 0))
    check("tile_split0", lambda: ht.tile(A, (2, 1)), lambda: full.repeat(2, 1), reps=1)
    torch.cuda.empty_cache()
    lo, hi = rows_total // 64, rows_total * 15 // 16  # 1024 and 61440: 15360, 16384, 16384, 12288 rows a rank
    B = A[lo:hi]
    check("balance_uneven", lambda: ht.balance(B, copy=True), lambda: full[lo:hi])
    out["balance_uneven"]["before"] = B.lshape_map[:, 0].tolist()
    del B
    check("collect", lambda: ht.collect(A, 0), lambda: full, reps=1)

    def halos():
        A.get_halo(2)
        return A
    _, info = counted(halos)
    first, last = r0 == 0, rank == WORLD - 1
    ok = (first or torch.equal(A.halo_prev, full[r0 - 2: r0])) and (first == (A.halo_prev is None)) and \
        (last or torch.equal(A.halo_next, full[r0 + WORLD_MANIP_ROWS: r0 + WORLD_MANIP_ROWS + 2])) and \
        (last == (A.halo_next is None))
    _every_rank_ok(comm, ok, f"world get_halo(2) differs from the neighbours' rows on rank {rank}")
    out["get_halo"] = {**info, "ms": _world_ms(halos, 2)}
    del A, full
    torch.cuda.empty_cache()

    gen.manual_seed(WORLD_MANIP_SEED + 1)
    xw = torch.randn(WORLD * WORLD_CONV_N, device=dev, generator=gen)
    vw = torch.randn(CONV_K, device=dev, generator=gen)
    X = ht.array(xw[rank * WORLD_CONV_N: (rank + 1) * WORLD_CONV_N].clone(), is_split=0)
    v = ht.array(vw)
    left, right = CONV_K // 2, CONV_K - 1 - CONV_K // 2
    res, info = counted(lambda: ht.convolve(X, v, "same"))
    ref = _conv_ref(xw, vw, left, right, torch.float32)
    err = float((res.larray - mine(res, ref)).abs().max()) / (TOL_CONV * _conv_scale(xw, vw))
    _every_rank_ok(comm, err <= 1.0, f"world convolve differs from world size 1's on rank {rank} ({err:.3e})")
    out["convolve"] = {**info, "ms": _world_ms(lambda: ht.convolve(X, v, "same"), 2), "err": err}
    del X, v, xw, vw, res, ref
    torch.cuda.empty_cache()

    m, n, r = GALLERY
    ht.random.seed(MANIP_SEED + 1)
    G, (_, s, _) = matrixgallery.random_known_rank(m, n * WORLD, r, split=1)
    _, sigma, _, _ = ht.linalg.hsvd_rank(G, r, compute_sv=True)
    want = torch.sort(s.larray, descending=True).values
    sig_err = float((sigma.larray - want).abs().max() / want[0])
    _every_rank_ok(comm, sig_err <= TOL_GALLERY, f"world gallery: hsvd_rank's sigma off by {sig_err:.3e} on rank {rank}")
    out["gallery"] = {"sigma_err": sig_err, "lshape": list(G.lshape)}
    torch.cuda.empty_cache()
    return out


def _report_world_manip(per: list, shared: str) -> dict:
    """Print the manipulation phase of the world; returns its collective
    counts a call."""
    rows = WORLD * WORLD_MANIP_ROWS
    gb = 4.0 * rows * N
    harness = sum(4.0 * m * n for m, n, _ in CONCAT_HARNESS)
    what = {
        "concat_harness": ("concatenate(harness, 1), splits 1/None/1 (the chunk geometry of the result)",
                           2 * harness),
        "concat_split0": (f"concatenate([A, A], 0), A {WORLD * WORLD_MANIP_ROWS}x{N} float32 split 0", 4 * gb),
        "pad_split0": ("pad(A, ((1, 1), (2, 2))) (rows where they fall)", 2 * gb),
        "roll_split0": ("roll(A, 1000, 0) (A's layout)", 2 * gb),
        "repeat_split0": ("repeat(A, 2, 0) (rows where they fall)", 3 * gb),
        "tile_split0": ("tile(A, (2, 1)) (the chunk geometry of the result)", 3 * gb),
        "balance_uneven": (f"balance(A[{rows // 64}:{rows * 15 // 16}], copy=True)",
                           2 * 4.0 * (rows * 15 // 16 - rows // 64) * N),
        "collect": ("collect(A, 0) (every row to rank 0)", 2 * gb),
        "get_halo": ("A.get_halo(2)", 0.0),
        "convolve": (f"convolve(randn({WORLD * WORLD_CONV_N}) split 0, randn({CONV_K}), 'same'), within {TOL_CONV} "
                     f"of the magnitudes' convolution", 2 * 4.0 * WORLD * WORLD_CONV_N),
    }
    counts = {}
    for name, (text, nbytes) in what.items():
        each = [p[name] for p in per]
        counts[name] = each[0]["counts"]
        flops = 2.0 * WORLD * WORLD_CONV_N * CONV_K if name == "convolve" else 0.0
        bound, by = _bound(nbytes, flops)
        print(
            f"world manip {name}: {text}: {each[0]['ms']:.4f} ms a call (rank 0, median of {each[0].get('reps', 2)}; ranks "
            f"{[round(e['ms'], 4) for e in each]}), bound {bound:.4f} ms ({by}, one card); equal to the torch formula "
            f"on every rank{' (err ' + format(max(e['err'] for e in each), '.3e') + ' of the limit)' if name == 'convolve' else ' bit for bit'}; "
            f"collectives a rank {[e['counts'] for e in each]}, bytes a rank put in {[e['bytes'] for e in each]}, "
            f"staged through the host {[e['staged'] for e in each]} B a rank"
            + (f"; result rows a rank {each[0]['lshape_map']}" if "lshape_map" in each[0] else "")
            + (f"; before {each[0]['before']}" if "before" in each[0] else "") + f"; {shared}", flush=True,
        )
    m, n, r = GALLERY
    print(f"world manip gallery: random_known_rank({m}, {n * WORLD}, {r}, split=1) and hsvd_rank: max |Δσ| / σ_max "
          f"{max(p['gallery']['sigma_err'] for p in per):.3e} (tol {TOL_GALLERY}), shards {[p['gallery']['lshape'] for p in per]}",
          flush=True)
    return counts


# --------------------------------------------------------------------- #
# the dense factorizations and the iterative solvers                    #
# --------------------------------------------------------------------- #
LINALG_SEED = 20  # the seed of the factorization phase's draws
POLAR_SHAPE = (65536, 1024)  # heat_tpu's golden polar plan (factorizations.py:223)
FACT_N = 8192  # its golden cholesky/lu plans (:225-228)
SOLVE_NRHS = 256  # its golden solve plans (:229-232)
EIGH_N = 4096
WORLD_EIGH_N = 2048  # splits at order >= 512 (_EIGH_RESPLIT_MIN_N): recurses
LANCZOS_M = 64
TOL_FACTOR = 1e-5  # ‖A − LLᴴ‖_F/‖A‖_F, ‖A[perm] − LU‖_F/‖A‖_F
TOL_ORTHO = 1e-4  # max |UᴴU − I|
TOL_SOLVE = 1e-4  # ‖Ax − b‖_F/‖b‖_F, ‖AX − I‖_F/‖I‖_F
TOL_SIGMA = 1e-4  # max |Δσ|/σ_max against torch.linalg.svdvals (heat_tpu's documented tolerance)
TOL_EIG = 1e-4  # max |Δλ|/‖A‖₂ against float64 eigvalsh
TOL_DET = 1e-3  # |Δdet|/|det| against float64


def _linalg_operands(ht, n: int, rows: slice):
    """Rows ``rows`` of the phase's two 8192² float32 operands, made from
    ``ht.random.randn(n, n)`` after ``seed(LINALG_SEED)`` (R1): GEN = I +
    0.1·G/√n with its rows shuffled within each block of n/4 (a permutation
    seeded by the block), whose LU pivots back within the block and whose
    determinant is finite in float32 (its eigenvalues lie within 0.1 of 1),
    and SPD = I + 0.1·(G + Gᵀ)/√(2n) (eigenvalues in [0.8, 1.2])."""
    import torch

    ht.random.seed(LINALG_SEED)
    g = ht.random.randn(n, n).larray
    dev = g.device
    eye = torch.zeros((rows.stop - rows.start, n), device=dev)
    eye[torch.arange(rows.stop - rows.start, device=dev), torch.arange(rows.start, rows.stop, device=dev)] = 1
    spd = eye + 0.1 * (g[rows] + g[:, rows].T) / math.sqrt(2 * n)
    gen = eye + 0.1 * g[rows] / math.sqrt(n)
    nb = n // WORLD
    order = []
    for b in range(rows.start // nb, -(-rows.stop // nb)):
        gen_b = torch.Generator().manual_seed(LINALG_SEED + b)
        order.append(b * nb + torch.randperm(nb, generator=gen_b))
    order = torch.cat(order).to(dev) - rows.start
    return gen[order], spd


def _symmetric(ht, n: int, seed: int):
    """(G + Gᵀ)/√(2n) of ``ht.random.randn(n, n)`` after ``seed(seed)``, float32:
    eigenvalues on the semicircle of radius 2, both signs."""
    ht.random.seed(seed)
    g = ht.random.randn(n, n).larray
    return (g + g.T) / math.sqrt(2 * n)


def _fro_rel(x, ref) -> float:
    return float(x.double().norm() / ref.double().norm().clamp_min(1e-300))


def _ortho_err(x, comm=None) -> float:
    """max |XᴴX − I| (the Gram all-reduced across ranks with ``comm``)."""
    import torch

    g = x.double().T @ x.double()
    if comm is not None:
        g = comm.allreduce(g)
    return float((g - torch.eye(g.shape[0], dtype=g.dtype, device=g.device)).abs().max())


def linalg_path(dev) -> dict:
    """The factorizations at world size 1, at heat_tpu's golden plans'
    shapes (factorizations.py:223-232): ``polar`` of 65536 x 1024 float32
    (``ht.random.randn``), ``cholesky``/``lu`` of 8192², ``solve`` with 8192
    x 256 right-hand sides (``assume_a="pos"`` and ``"gen"``), ``inv`` and
    ``det`` of 8192², ``svd`` of the polar operand (``method="qr"`` and
    ``"polar"``, and values only, against float64 σ), ``eigh`` of a 4096² symmetric matrix, ``cg``
    on 4096² SPD float64 to its stop test, ``lanczos`` of the eigh operand
    with m = 64 (its start vector drawn, R1). Operands: ``_linalg_operands``.
    Each result is held to its limit (``TOL_*``), finite, and each call
    timed under CUDA events beside its operation bound (the FLOP counts
    below over 67 TFLOP/s FP32; cg and lanczos: A read once a step over
    3.35 TB/s). At world size 1 the calls are ``torch.linalg``'s (cuSOLVER,
    cuBLAS) but ``polar`` (Newton–Schulz in cuBLAS products) and ``svd``
    (its qr and polar routes on the whole tensor). Returns the rows and
    R1's launches."""
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.core.linalg import factorizations as facts

    rows, refs, r1 = [], {}, {}
    t_phase = time.perf_counter()

    def row(name, what, ms, flops, nbytes, err, limit, **extra):
        bound, by = _bound(nbytes, flops)
        rows.append({"name": name, "ms": ms, "bound_ms": bound, "bound_by": by, "flop": flops, "bytes": nbytes,
                     "err": err, "limit": limit, **extra})
        print(f"linalg {name}: {what}: {ms:.4f} ms (median of CUDA events), bound {bound:.4f} ms ({by}: "
              f"{flops / 1e9:.1f} GFLOP at 67 TFLOP/s, {nbytes / 1e9:.3f} GB at 3.35 TB/s); err {err:.3e} "
              f"(limit {limit})" + "".join(f", {k} {v}" for k, v in extra.items()), flush=True)
        _require(err <= limit, f"linalg {name}: err {err:.3e} above {limit}")

    m, n = POLAR_SHAPE
    ht.random.seed(LINALG_SEED)
    A = ht.random.randn(m, n, split=0)
    facts.HOST_READS = 0
    U, H = ht.linalg.polar(A)
    it, reads = facts.POLAR_ITERATIONS, facts.HOST_READS
    u, h, a = U.larray, H.larray, A.larray
    _require(bool(torch.isfinite(u).all() and torch.isfinite(h).all()), "polar: non-finite factors")
    _require(bool(torch.equal(h, h.T)), "polar: H is not symmetric")
    recon = _fro_rel(a - u @ h, a)
    ms = _median_ms(lambda: ht.linalg.polar(A), 3)
    row("polar", f"ht.linalg.polar({m}x{n} float32 split 0)", ms, it * 4.0 * m * n * n + 2.0 * m * n * n, 0.0,
        _ortho_err(u), TOL_ORTHO, iterations=it, host_reads=reads, reconstruction=f"{recon:.3e}")
    del U, H, u, h

    # the reference: float64 σ by the QR iteration (torch's default SVD on the
    # card, cuSOLVER's Jacobi, is 2.1e-4 of σ_max off in float32)
    refs["sigma"] = torch.linalg.svdvals(a.double(), driver="gesvd" if a.is_cuda else None)
    svd_flops = {"qr": 6.0 * m * n * n - 4.0 * n ** 3 / 3,
                 "polar": it * 4.0 * m * n * n + 4.0 * m * n * n + 10.0 * n ** 3 / 3}
    svd_what = {"qr": "torch.linalg.qr, R's SVD by the QR iteration, U = Q·U_R",
                "polar": "ht.linalg.polar, eigh of H, U = U_p·V"}
    for method in ("qr", "polar"):
        Us, S, Vh = ht.linalg.svd(A, method=method)
        s = S.larray
        err = float((s.double() - refs["sigma"]).abs().max() / refs["sigma"][0])
        recon = _fro_rel(a - (Us.larray * s) @ Vh.larray, a)
        ortho = _ortho_err(Us.larray)
        _require(ortho <= TOL_ORTHO and recon <= TOL_ORTHO, f"svd({method}): U orthonormality {ortho:.3e}, "
                 f"reconstruction {recon:.3e}")
        ms = _median_ms(lambda: ht.linalg.svd(A, method=method), 3)
        row(f"svd_{method}", f"ht.linalg.svd({m}x{n}, method={method!r}) ({svd_what[method]}); σ against float64 "
            f"gesvd", ms, svd_flops[method], 0.0, err, TOL_SIGMA, orthonormality=f"{ortho:.3e}",
            reconstruction=f"{recon:.3e}")
        del Us, S, Vh
    s = ht.linalg.svd(A, compute_uv=False).larray
    ms = _median_ms(lambda: ht.linalg.svd(A, compute_uv=False), 3)
    row("svdvals", f"ht.linalg.svd({m}x{n}, compute_uv=False) (R's singular values)", ms,
        2.0 * m * n * n - 2.0 * n ** 3 / 3, 0.0, float((s.double() - refs["sigma"]).abs().max() / refs["sigma"][0]),
        TOL_SIGMA)
    WORLD_REFERENCE["linalg_sigma"] = refs["sigma"].cpu()
    del A, a, s

    nf = FACT_N
    gen_t, spd_t = _linalg_operands(ht, nf, slice(0, nf))
    G, P = ht.array(gen_t), ht.array(spd_t)
    L = ht.linalg.cholesky(P).larray
    ms = _median_ms(lambda: ht.linalg.cholesky(P), 5)
    row("cholesky", f"ht.linalg.cholesky({nf}² SPD float32); ‖A − LLᴴ‖_F/‖A‖_F", ms, nf ** 3 / 3.0, 0.0,
        _fro_rel(spd_t - L @ L.T, spd_t), TOL_FACTOR)
    perm, Lg, Ug = ht.linalg.lu(G)
    p_t = perm.larray.long()
    WORLD_REFERENCE["linalg_perm"] = p_t.cpu()
    _require(bool(torch.equal(torch.sort(p_t).values, torch.arange(nf, device=dev))), "lu: perm is no permutation")
    ms = _median_ms(lambda: ht.linalg.lu(G), 5)
    row("lu", f"ht.linalg.lu({nf}² float32, rows shuffled within blocks of {nf // WORLD}); ‖A[perm] − LU‖_F/‖A‖_F",
        ms, 2.0 * nf ** 3 / 3, 0.0, _fro_rel(gen_t[p_t] - Lg.larray @ Ug.larray, gen_t), TOL_FACTOR,
        moved_rows=int((p_t != torch.arange(nf, device=dev)).sum()))
    gen_b = torch.Generator(device=dev).manual_seed(LINALG_SEED)
    b_t = torch.randn(nf, SOLVE_NRHS, device=dev, generator=gen_b)
    B = ht.array(b_t)
    for assume, op, factor in (("pos", P, nf ** 3 / 3.0), ("gen", G, 2.0 * nf ** 3 / 3)):
        x = ht.linalg.solve(op, B, assume_a=assume).larray
        ms = _median_ms(lambda: ht.linalg.solve(op, B, assume_a=assume), 5)
        row(f"solve_{assume}", f"ht.linalg.solve({nf}², {nf}x{SOLVE_NRHS}, assume_a={assume!r}); ‖Ax − b‖/‖b‖",
            ms, factor + 2.0 * nf * nf * SOLVE_NRHS, 0.0, _fro_rel(op.larray @ x - b_t, b_t), TOL_SOLVE)
    lf, uf, pf = Lg.larray, Ug.larray, p_t
    ms = _median_ms(lambda: facts._apply_factor_local("lu", b_t, lf, uf, pf), 5)
    x = facts._apply_factor_local("lu", b_t, lf, uf, pf)
    row("solve_factored", f"the two triangular solves against lu's factors ({nf}² , {SOLVE_NRHS} columns)", ms,
        2.0 * nf * nf * SOLVE_NRHS, 0.0, _fro_rel(gen_t @ x - b_t, b_t), TOL_SOLVE)
    del L, Lg, Ug, lf, uf, x, B, b_t
    X = ht.linalg.inv(G).larray
    eye = torch.eye(nf, device=dev)
    ms = _median_ms(lambda: ht.linalg.inv(G), 3)
    row("inv", f"ht.linalg.inv({nf}² float32); ‖AX − I‖_F/‖I‖_F", ms, 8.0 * nf ** 3 / 3, 0.0,
        _fro_rel(gen_t @ X - eye, eye), TOL_SOLVE)
    del X, eye
    d = float(ht.linalg.det(G).larray)
    d64 = float(torch.linalg.det(gen_t.double()))
    _require(math.isfinite(d) and d != 0.0 and (d > 0) == (d64 > 0), f"det {d} against {d64}")
    ms = _median_ms(lambda: ht.linalg.det(G), 5)
    row("det", f"ht.linalg.det({nf}² float32) = {d:.6e} (float64: {d64:.6e})", ms, 2.0 * nf ** 3 / 3, 0.0,
        abs(d - d64) / abs(d64), TOL_DET)
    WORLD_REFERENCE["linalg_det"] = d64
    del G, P, gen_t, spd_t

    ne = EIGH_N
    S_t = _symmetric(ht, ne, LINALG_SEED + 1)
    Se = ht.array(S_t)
    w, v = ht.linalg.eigh(Se)
    w64 = torch.linalg.eigvalsh(S_t.double())
    norm2 = float(w64.abs().max())
    eig_err = float((w.larray.double() - w64).abs().max()) / norm2
    resid = _fro_rel(S_t @ v.larray - v.larray * w.larray, S_t)
    ms = _median_ms(lambda: ht.linalg.eigh(Se), 3)
    row("eigh", f"ht.linalg.eigh({ne}² symmetric float32) (torch.linalg.eigh at world size 1); λ against float64 "
        f"eigvalsh, over ‖A‖₂", ms, (4.0 / 3 + 2) * ne ** 3, 0.0, eig_err, TOL_EIG,
        orthonormality=f"{_ortho_err(v.larray):.3e}", residual=f"{resid:.3e}")
    del w, v

    spd64 = torch.eye(ne, device=dev, dtype=torch.float64) + 0.1 * S_t.double()
    A64, b64 = ht.array(spd64), ht.array(torch.ones(ne, device=dev, dtype=torch.float64))
    x0 = ht.zeros(ne, dtype=ht.float64)
    facts.HOST_READS = 0
    x = ht.linalg.cg(A64, b64, x0).larray
    steps = facts.HOST_READS - 1
    _require(steps < ne, "cg did not reach its stop test")
    ms = _median_ms(lambda: ht.linalg.cg(A64, b64, x0), 3)
    row("cg", f"ht.linalg.cg(I + 0.1·S, {ne}² float64, b = 1) to rᵀr < 1e-20 in {steps} steps; ‖Ax − b‖/‖b‖", ms,
        steps * 2.0 * ne * ne, steps * 8.0 * ne * ne, _fro_rel(spd64 @ x - b64.larray, b64.larray), TOL_SOLVE,
        steps=steps)
    del A64, b64, x, spd64

    _r1_zero()
    V, T = ht.linalg.lanczos(Se, LANCZOS_M)
    torch.cuda.synchronize()
    r1["lanczos"] = _r1_read("linalg_lanczos", 1, [ne])
    vt = V.larray
    proj_err = float((vt.T @ S_t @ vt - T.larray).abs().max()) / norm2
    ortho = _ortho_err(vt)
    _require(ortho <= TOL_ORTHO, f"lanczos: V's orthonormality {ortho:.3e}")
    ms = _median_ms(lambda: ht.linalg.lanczos(Se, LANCZOS_M, v0=V[:, 0]), 3)
    flops = LANCZOS_M * 2.0 * ne * ne + sum(4.0 * ne * i for i in range(LANCZOS_M))
    row("lanczos", f"ht.linalg.lanczos({ne}² float32, m={LANCZOS_M}) (start vector drawn: R1 once); max |VᵀAV − T| "
        f"over ‖A‖₂", ms, flops, LANCZOS_M * 4.0 * ne * ne, proj_err, TOL_EIG, orthonormality=f"{ortho:.3e}")
    print(f"linalg phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"rows": rows, "r1": r1}


def _world_linalg(ht, comm, moved: dict, rank: int, dev) -> dict:
    """The factorizations across ranks: ``polar`` and ``svd`` (``"qr"``,
    ``"polar"``, values only) of the 65536 x 1024 operand split 0 (the
    world-size-1 draw, 16384 rows a rank); ``cholesky``, ``lu``, ``solve``
    (both kinds, 8192 x 256 split 0), ``inv`` of the 8192² operands split 0
    and ``det`` of GEN split 1; ``eigh`` of a 2048² symmetric matrix split 0,
    which recurses (sub-problems of order ≥ 512). Each rank checks its rows
    against the limits of ``linalg_path`` (gathering the factor it needs
    after the counted call), the collectives it issued against the
    docstrings' counts, LU's perm against world size 1's (block-local
    pivoting finds the same rows on this operand) and the sign, det, σ and
    eigenvalues equal on every rank."""
    import torch

    from heat_tpu_torch.core.linalg import factorizations as facts
    from heat_tpu_torch.kernels import threefry as kt

    out = {}
    p = comm.size

    def counted(call):
        comm.counts.clear()
        moved.clear()
        comm.staged_bytes = 0
        facts.HOST_READS = 0
        _r1_zero()
        res = call()
        torch.cuda.synchronize()
        return res, {"counts": dict(comm.counts), "bytes": dict(moved), "staged": comm.staged_bytes,
                     "reads": facts.HOST_READS, "iterations": facts.POLAR_ITERATIONS, "r1": kt.THREEFRY_LAUNCHES}

    def same_everywhere(t) -> bool:
        every = comm.allgather(t.reshape(1, -1).double())
        return bool((every == every[0]).all())

    def finish(name, rec, want, err, limit, fn, reps, **extra):
        ok = (want is None or rec["counts"] == want) and err <= limit
        _every_rank_ok(comm, ok, f"world linalg {name}: counts {rec['counts']} (want {want}), err {err:.3e} "
                                 f"(limit {limit})")
        rec.update(err=err, limit=limit, ms=_world_ms(fn, reps), reps=reps, **extra)
        out[name] = rec
        torch.cuda.empty_cache()

    m, n = POLAR_SHAPE
    ht.random.seed(LINALG_SEED)
    A = ht.random.randn(m, n, split=0)
    (U, H), rec = counted(lambda: ht.linalg.polar(A))
    it = rec["iterations"]
    herm = bool(torch.equal(H.larray, H.larray.T)) and same_everywhere(H.larray)
    _every_rank_ok(comm, herm, "world polar: H is not symmetric or differs across ranks")
    finish("polar", rec, {"all-gather": 1, "all-reduce": it + 1}, _ortho_err(U.larray, comm), TOL_ORTHO,
           lambda: ht.linalg.polar(A), 2)
    del U, H
    sigma_ref = WORLD_REFERENCE["linalg_sigma"].to(dev).float()
    for method, want in (("qr", {"all-gather": 1}), ("polar", None)):
        (Us, S, Vh), rec = counted(lambda: ht.linalg.svd(A, method=method))
        if method == "polar":
            want = {"all-gather": 1, "all-reduce": rec["iterations"] + 1}
        s = S.larray
        ortho = _ortho_err(Us.larray, comm)
        ok = ortho <= TOL_ORTHO and same_everywhere(s)
        _every_rank_ok(comm, ok, f"world svd({method}): U's orthonormality {ortho:.3e}, or σ differs across ranks")
        finish(f"svd_{method}", rec, want, float((s - sigma_ref).abs().max() / sigma_ref[0]), TOL_SIGMA,
               lambda: ht.linalg.svd(A, method=method), 2, orthonormality=ortho)
        del Us, S, Vh
    S, rec = counted(lambda: ht.linalg.svd(A, compute_uv=False))
    finish("svdvals", rec, {"all-gather": 1}, float((S.larray - sigma_ref).abs().max() / sigma_ref[0]), TOL_SIGMA,
           lambda: ht.linalg.svd(A, compute_uv=False), 2)
    del A, S

    nf = FACT_N
    start, (nrows, _), _ = comm.chunk((nf, nf), 0)
    rows = slice(start, start + nrows)
    gen_r, spd_r = _linalg_operands(ht, nf, rows)
    G, P = ht.array(gen_r, is_split=0), ht.array(spd_r, is_split=0)
    lu_counts = {"all-gather": p, "broadcast": p - 1}

    def rel_rows(resid, ref) -> float:
        num = comm.allreduce(resid.double().pow(2).sum())
        den = comm.allreduce(ref.double().pow(2).sum())
        return float((num / den.clamp_min(1e-300)).sqrt())

    L, rec = counted(lambda: ht.linalg.cholesky(P))
    l_all = comm.allgather(L.larray)
    finish("cholesky", rec, {"all-gather": p}, rel_rows(spd_r - L.larray @ l_all.T, spd_r), TOL_FACTOR,
           lambda: ht.linalg.cholesky(P), 2)
    del L, l_all
    (perm, Lg, Ug, sign), rec = counted(lambda: facts._lu_factor(G))
    p_loc = perm.larray.long()
    p_all = comm.allgather(p_loc)
    ok = bool(((p_loc >= start) & (p_loc < start + nrows)).all()) and same_everywhere(sign)
    ok = ok and bool(torch.equal(p_all.cpu(), WORLD_REFERENCE["linalg_perm"]))
    _every_rank_ok(comm, ok, "world lu: perm leaves its block, differs from world size 1's, or the sign differs")
    u_all = comm.allgather(Ug.larray)
    finish("lu", rec, lu_counts, rel_rows(gen_r[p_loc - start] - Lg.larray @ u_all, gen_r), TOL_FACTOR,
           lambda: ht.linalg.lu(G), 2, sign=int(sign), moved_rows=int((p_all != torch.arange(nf, device=dev)).sum()))
    del Lg, Ug, u_all
    gen_b = torch.Generator(device=dev).manual_seed(LINALG_SEED)
    b_r = torch.randn(nf, SOLVE_NRHS, device=dev, generator=gen_b)[rows]
    B = ht.array(b_r, is_split=0)
    for assume, op, a_r, want in (("pos", P, spd_r, {"all-gather": 2 * p - 1, "broadcast": p - 1}),
                                  ("gen", G, gen_r, {"all-gather": p, "broadcast": 3 * (p - 1)})):
        x, rec = counted(lambda: ht.linalg.solve(op, B, assume_a=assume))
        x_all = comm.allgather(x.larray)
        finish(f"solve_{assume}", rec, want, rel_rows(a_r @ x_all - b_r, b_r), TOL_SOLVE,
               lambda: ht.linalg.solve(op, B, assume_a=assume), 2)
    del x, x_all, B
    X, rec = counted(lambda: ht.linalg.inv(G))
    eye_r = torch.zeros((nrows, nf), device=dev)
    eye_r[torch.arange(nrows, device=dev), torch.arange(start, start + nrows, device=dev)] = 1
    x_all = comm.allgather(X.larray)
    finish("inv", rec, {"all-gather": p, "broadcast": 3 * (p - 1)}, rel_rows(gen_r @ x_all - eye_r, eye_r), TOL_SOLVE,
           lambda: ht.linalg.inv(G), 1)
    del X, x_all, eye_r
    G1 = G.resplit(1)
    d, rec = counted(lambda: ht.linalg.det(G1))
    d_t = d.larray
    _every_rank_ok(comm, same_everywhere(d_t), "world det: differs across ranks")
    d64 = WORLD_REFERENCE["linalg_det"]
    moves = ht.redistribution.explain(G1, 0).collective_counts()  # the planner's resplit to split 0
    finish("det_split1", rec, {**moves, **lu_counts, "all-reduce": 1}, abs(float(d_t) - d64) / abs(d64),
           TOL_DET, lambda: ht.linalg.det(G1), 2, det=float(d_t))
    del G, G1, P, gen_r, spd_r

    ne = WORLD_EIGH_N
    s_all = _symmetric(ht, ne, LINALG_SEED + 2)
    start_e, (rows_e, _), _ = comm.chunk((ne, ne), 0)
    Se = ht.array(s_all[start_e:start_e + rows_e].clone(), is_split=0)
    nodes = []
    polar_plain = facts.polar

    def polar_counted(*args, **kw):
        nodes.append(1)
        return polar_plain(*args, **kw)

    facts.polar = polar_counted
    try:
        (w, v), rec = counted(lambda: ht.linalg.eigh(Se))
    finally:
        facts.polar = polar_plain
    w64 = torch.linalg.eigvalsh(s_all.double())
    norm2 = float(w64.abs().max())
    ortho = _ortho_err(v.larray, comm)
    ok = same_everywhere(w.larray) and ortho <= TOL_ORTHO and rec["r1"] == 2 * len(nodes)
    _every_rank_ok(comm, ok, f"world eigh: eigenvalues differ across ranks, eigenvectors' orthonormality {ortho:.3e}, "
                             f"or R1 launched {rec['r1']} times for {len(nodes)} spectral splits")
    finish("eigh", rec, None, float((w.larray.double() - w64).abs().max()) / norm2, TOL_EIG,
           lambda: ht.linalg.eigh(Se), 1, nodes=len(nodes), orthonormality=ortho)
    return out


WORLD_LINALG_WHAT = {
    "polar": (f"ht.linalg.polar({POLAR_SHAPE[0]}x{POLAR_SHAPE[1]} float32 split 0); max |UᴴU − I|", None),
    "svd_qr": (f"ht.linalg.svd({POLAR_SHAPE[0]}x{POLAR_SHAPE[1]} split 0, method='qr'); max |Δσ|/σ_max", None),
    "svd_polar": (f"ht.linalg.svd({POLAR_SHAPE[0]}x{POLAR_SHAPE[1]} split 0, method='polar'); max |Δσ|/σ_max", None),
    "svdvals": (f"ht.linalg.svd({POLAR_SHAPE[0]}x{POLAR_SHAPE[1]} split 0, compute_uv=False); max |Δσ|/σ_max", None),
    "cholesky": (f"ht.linalg.cholesky({FACT_N}² SPD split 0); ‖A − LLᴴ‖_F/‖A‖_F", FACT_N ** 3 / 3.0),
    "lu": (f"ht.linalg.lu({FACT_N}² split 0), block-local pivots; ‖A[perm] − LU‖_F/‖A‖_F", 2.0 * FACT_N ** 3 / 3),
    "solve_pos": (f"ht.linalg.solve({FACT_N}² SPD, {FACT_N}x{SOLVE_NRHS}, 'pos'); ‖Ax − b‖/‖b‖",
                  FACT_N ** 3 / 3.0 + 2.0 * FACT_N ** 2 * SOLVE_NRHS),
    "solve_gen": (f"ht.linalg.solve({FACT_N}², {FACT_N}x{SOLVE_NRHS}, 'gen'); ‖Ax − b‖/‖b‖",
                  2.0 * FACT_N ** 3 / 3 + 2.0 * FACT_N ** 2 * SOLVE_NRHS),
    "inv": (f"ht.linalg.inv({FACT_N}² split 0); ‖AX − I‖_F/‖I‖_F", 8.0 * FACT_N ** 3 / 3),
    "det_split1": (f"ht.linalg.det({FACT_N}² split 1); |Δdet|/|det| against float64", 2.0 * FACT_N ** 3 / 3),
    "eigh": (f"ht.linalg.eigh({WORLD_EIGH_N}² symmetric split 0), divide and conquer; max |Δλ|/‖A‖₂",
             (4.0 / 3 + 2) * WORLD_EIGH_N ** 3),
}


def _report_world_linalg(per: list, shared: str) -> dict:
    """Print the factorization phase of the world; returns R1's launches a
    rank under eigh."""
    m, n = POLAR_SHAPE
    for name, (what, flops) in WORLD_LINALG_WHAT.items():
        each = [p[name] for p in per]
        e = each[0]
        if flops is None:
            steps = e["iterations"] if name in ("polar", "svd_polar") else 0
            flops = {"polar": steps * 4.0 * m * n * n + 2.0 * m * n * n,
                     "svd_polar": steps * 4.0 * m * n * n + 4.0 * m * n * n,
                     "svd_qr": 6.0 * m * n * n - 2.0 * n ** 3 / 3}.get(name, 2.0 * m * n * n - 2.0 * n ** 3 / 3)
        bound, by = _bound(0.0, flops)
        extra = "".join(f", {k} {e[k]}" for k in ("iterations", "sign", "det", "moved_rows", "nodes") if k in e
                        and (k != "iterations" or "polar" in name or name == "eigh"))
        print(
            f"world linalg {name}: {what}: {e['ms']:.4f} ms a call (rank 0, median of {e['reps']}; ranks "
            f"{[round(x['ms'], 4) for x in each]}), bound {bound:.4f} ms ({by}: {flops / 1e9:.1f} GFLOP at 67 TFLOP/s "
            f"on one card); err {max(x['err'] for x in each):.3e} (limit {e['limit']}){extra}; stop-test reads a rank "
            f"{[x['reads'] for x in each]}; R1 launches a rank {[x['r1'] for x in each]}; collectives a rank "
            f"{e['counts']}, bytes a rank put in {e['bytes']}, staged through the host "
            f"{[x['staged'] for x in each]} B a rank; {shared}", flush=True,
        )
    return {"eigh_r1": [p["eigh"]["r1"] for p in per], "eigh_nodes": [p["eigh"]["nodes"] for p in per]}


# --------------------------------------------------------------------- #
# the estimators (no kernel of their own: K3, K4, K7 and R1 under them)  #
# --------------------------------------------------------------------- #
EST_SEED = 22  # the seed of the estimator phase's draws
EST_REPS = 3
TOL_EST = 1e-5  # scalers against float64 statistics, their transform and round trip, of the largest magnitude
TOL_NB = 1e-4  # GaussianNB's θ and var against float64, relative
NB_PEAK = 3.0  # GaussianNB.predict's peak allocation, at most this many times X
LASSO_LAM, LASSO_NONZERO, LASSO_NOISE = 0.01, 8, 0.1
TOL_LASSO = 1e-4  # θ against a float64 fit of the same data, of max|θ|
KNN_N, KNN_Q, KNN_K = 65536, 16384, 5
SPEC_N, SPEC_K, SPEC_GAMMA, SPEC_LANCZOS = 32768, 8, 0.05, 300
EMB_K, EMB_M = 8, 64
TOL_EMB = 1e-4  # Ritz values and embedding columns (up to sign) against the float64 run with K7's plain version
WORLD_EST_DIV = 8  # the world's operands: 1/8 of world size 1's rows
TOL_WORLD_EST = 1e-5  # the world's fitted statistics against world size 1's, relative


def _est_rel(got, ref) -> float:
    """max |got − ref| / max |ref|, in float64."""
    import torch

    got, ref = torch.as_tensor(got).double(), torch.as_tensor(ref).double().to(torch.as_tensor(got).device)
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


def _scaler_reference(a) -> dict:
    """The scalers' statistics of ``a`` (rows along axis 0) from a float64
    pass on the card, and the quantiles from ATen's sort of each column."""
    import torch

    a64 = a.double()
    ref = {"mean": a64.mean(0), "var": a64.var(0, correction=0), "min": a.amin(0).double(), "max": a.amax(0).double(),
           "max_abs": a.abs().amax(0).double()}
    del a64
    s = torch.sort(a, dim=0).values
    n = a.shape[0]
    for name, q in (("median", 50.0), ("q_lo", 25.0), ("q_hi", 75.0)):
        pos = q / 100.0 * (n - 1)
        lo, hi = math.floor(pos), math.ceil(pos)
        ref[name] = s[lo].double() + (pos - lo) * (s[hi].double() - s[lo].double())
    del s
    return ref


def _scaler_formula(name: str, rows, ref: dict):
    """The transform of ``rows`` from the float64 statistics."""
    r = rows.double()
    if name == "StandardScaler":
        return (r - ref["mean"]) / ref["var"].sqrt()
    if name == "MinMaxScaler":
        return (r - ref["min"]) / (ref["max"] - ref["min"])
    if name == "Normalizer":
        return r / r.norm(dim=1, keepdim=True)
    if name == "MaxAbsScaler":
        return r / ref["max_abs"]
    return (r - ref["median"]) / (ref["q_hi"] - ref["q_lo"])


def _scaler_stats(name: str, model) -> dict:
    """The fitted statistics of ``model`` under ``_scaler_reference``'s names."""
    whole = lambda v: v.resplit(None).larray if hasattr(v, "split") else v  # noqa: E731
    if name == "StandardScaler":
        return {"mean": whole(model.mean_), "var": whole(model.var_)}
    if name == "MinMaxScaler":
        return {"min": whole(model.data_min_), "max": whole(model.data_max_)}
    if name == "MaxAbsScaler":
        return {"max_abs": model.max_abs_}
    if name == "RobustScaler":
        return {"median": whole(model.center_)}
    return {}


def _scalers(ht, A, ref: dict, rows, label: str, reps: int, launches: dict) -> list:
    """Each scaler on ``A``: fit, transform and inverse, their statistics
    against ``ref`` (float64), the transform of ``rows`` (this rank's row
    indices) against the float64 formula, the round trip, K4's launches
    under ``RobustScaler``, and the call's CUDA-event median."""
    import torch

    from heat_tpu_torch.kernels import sort as ks
    from heat_tpu_torch.preprocessing import preprocessing as pp

    out = []
    a = A.larray
    for name in ("StandardScaler", "MinMaxScaler", "Normalizer", "MaxAbsScaler", "RobustScaler"):
        cls = getattr(ht.preprocessing, name)
        ks.SORT_LAUNCHES = 0
        model = cls().fit(A)
        torch.cuda.synchronize()
        k4 = ks.SORT_LAUNCHES
        T = model.transform(A)
        stats = _scaler_stats(name, model)
        errs = {key: _est_rel(v, ref[key]) for key, v in stats.items()}
        if name == "RobustScaler":
            errs["iqr"] = _est_rel(model.iqr_, ref["q_hi"] - ref["q_lo"])
        t_rows = T.larray[rows]
        errs["transform"] = _est_rel(t_rows, _scaler_formula(name, a[rows], ref))
        del t_rows
        call = lambda: model.fit(A).transform(A)  # noqa: E731
        if hasattr(model, "inverse_transform"):
            B = model.inverse_transform(T)
            errs["round_trip"] = float((B.larray - a).abs().max() / a.abs().max())
            del B
            call = lambda: model.inverse_transform(model.fit(A).transform(A))  # noqa: E731
        del T
        torch.cuda.empty_cache()
        ok = max(errs.values()) <= TOL_EST and (name != "RobustScaler" or k4 >= 1 or not a.is_cuda)
        _require(ok, f"{label} {name}: errors {errs} (tol {TOL_EST}), K4 launches {k4}")
        ms = _median_ms(call, reps) if reps else None
        passes = 5 if hasattr(model, "inverse_transform") else 3  # fit reads A; transform reads A, writes T; inverse
        launches[name] = k4
        out.append({"name": name, "ms": ms, "bytes": passes * 4.0 * a.numel(), "errs": errs, "k4": k4})
        del model
    return out


def _lasso_reference(G, c, lam: float, tol: float, max_iter: int):
    """``heat_tpu``'s cyclic coordinate descent on the Gram form, in float64
    NumPy on the host: (θ, sweeps)."""
    import numpy as np

    m = G.shape[0]
    th = np.zeros(m)
    it, diff = 0, np.inf
    while it < max_iter and diff >= tol:
        old = th.copy()
        for j in range(m):
            rho = c[j] - G[j] @ th + G[j, j] * th[j]
            den = max(G[j, j], 1e-30)
            th[j] = rho / den if j == 0 else (np.sign(rho) * max(abs(rho) - lam, 0.0)) / den
        it += 1
        diff = np.abs(th - old).max()
    return th, it


def _knn_reference(xq, xt, yt, k: int, classes: int):
    """The k-NN vote in float64 with (distance, index) ties: each query's
    distances sorted stably (float64's product form, whose cancellation
    stays far below float32's rounding)."""
    import torch

    out = []
    xt64 = xt.double()
    for s in range(0, xq.shape[0], 1024):
        d = torch.cdist(xq[s : s + 1024].double(), xt64, compute_mode="use_mm_for_euclid_dist")
        idx = torch.sort(d, dim=1, stable=True).indices[:, :k]
        votes = torch.nn.functional.one_hot(yt[idx], classes).sum(1)
        out.append(torch.argmax(votes, dim=1))
    return torch.cat(out)


def _est_operands(dev, div: int = 1):
    """The phase's draws on the card, from ``EST_SEED``: eight blobs of
    KMeans' shard (1/div of its rows) with their labels, the Lasso target,
    the KNN training set and queries, the Spectral blobs."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(EST_SEED)
    n = KM_N // div
    n -= n % KM_K
    x = _blobs(gen, n, _axis_means(dev, KM_D, KM_K))
    labels = torch.arange(KM_K, device=dev).repeat_interleave(n // KM_K)
    theta = torch.zeros(KM_D, device=dev)
    on = torch.arange(0, KM_D, KM_D // LASSO_NONZERO, device=dev)
    theta[on] = torch.linspace(1.0, 2.0, LASSO_NONZERO, device=dev) * (1.0 - 2.0 * (torch.arange(LASSO_NONZERO, device=dev) % 2))
    y = x @ theta + 0.5 + LASSO_NOISE * torch.randn(n, device=dev, generator=gen)
    kn, kq = KNN_N // div, KNN_Q // div
    xt = _blobs(gen, kn, _axis_means(dev, KM_D, KM_K))
    yt = torch.arange(KM_K, device=dev).repeat_interleave(kn // KM_K)
    xq = _blobs(gen, kq, _axis_means(dev, KM_D, KM_K))
    xs = _blobs(gen, SPEC_N // div, _axis_means(dev, KM_D, SPEC_K))
    return {"x": x, "labels": labels, "theta": torch.cat([torch.tensor([0.5], device=dev), theta]), "y": y,
            "xt": xt, "yt": yt, "xq": xq, "xs": xs}


def _nb_reference(x, labels, k: int):
    """Each class's mean and variance in float64 (the rows of class c are a
    contiguous block)."""
    import torch

    n = x.shape[0] // k
    theta, var = [], []
    for c in range(k):
        b = x[c * n : (c + 1) * n].double()
        theta.append(b.mean(0))
        var.append(b.var(0, correction=0))
    return torch.stack(theta), torch.stack(var)


def _lane_sort_routes(a, row) -> None:
    """The sort under ``RobustScaler``'s percentiles along axis 0 of ``a``,
    by its routes in one call: ``kernels.sort.sorted_lanes`` (K4, one pair
    sort of (lane, value) words), ``local_sort`` (ATen's stable sort of
    int64 keys, the route before ``sorted_lanes``) and ``torch.sort`` of
    the float32 columns (library); each equal to ``local_sort``'s values."""
    import torch

    from heat_tpu_torch.kernels import sort as ks

    want = ks.local_sort(a, 0)[0]
    ks.SORT_LAUNCHES = 0
    got = ks.sorted_lanes(a, 0)
    torch.cuda.synchronize()
    k4 = ks.SORT_LAUNCHES
    same = {"sorted_lanes": torch.equal(got, want),
            "torch_sort": torch.equal(torch.sort(a, dim=0, stable=True).values, want)}
    del got, want
    torch.cuda.empty_cache()
    _require(all(same.values()) and k4 == 1, f"lane sort routes: equal to local_sort {same}, K4 launches {k4}")
    ms = {"local_sort_ms": _median_ms(lambda: ks.local_sort(a, 0), EST_REPS),
          "library_ms": _median_ms(lambda: torch.sort(a, dim=0, stable=True), EST_REPS)}
    lane_ms = _median_ms(lambda: ks.sorted_lanes(a, 0), EST_REPS)
    row("robust_scaler_lane_sort", lane_ms, 2 * 4.0 * a.numel(), 0.0, 0.0, 0.0, {"K4": k4},
        what="percentile's sort along axis 0 of 65536x8192 float32: sorted_lanes beside its other routes", **ms)
    torch.cuda.empty_cache()


def estimators_path(dev, inputs: dict) -> dict:
    """The estimators through the public entry points (``_est_operands``):
    the five scalers on the north-star operand, GaussianNB and Lasso on
    KMeans' shard, KNN, Laplacian and Spectral, and spectral_embedding on
    pagerank_2m's graph symmetrised; each row's time beside its bound and
    its error against the stated reference; the launches of K3, K4, K7 and
    R1 on these paths. Also the world's reference at 1/WORLD_EST_DIV size."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.classification import kneighborsclassifier as tknn
    from heat_tpu_torch.cluster import _cuda_assign as ca
    from heat_tpu_torch.core.linalg import factorizations as facts
    from heat_tpu_torch.core.linalg import solver
    from heat_tpu_torch.kernels import spmm as ks
    from heat_tpu_torch.kernels import threefry as kt
    from heat_tpu_torch.regression import lasso as tlasso
    from heat_tpu_torch.spatial import distance as tdist

    rows, launches = [], {}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]

    def row(name, ms, nbytes, flops, err, tol, kernels=None, **extra):
        bound_ms, bound_by = _bound(nbytes, flops)
        r = {"name": name, "card": card, "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by, "err": err, "tol": tol,
             "launches": kernels or {}, **extra}
        print(f"estimators {name}: {json.dumps(r)}", flush=True)
        rows.append(r)
        return r

    # scalers on the north-star operand
    ht.random.seed(EST_SEED)
    _r1_zero()
    A = ht.random.randn(M, N, split=0)
    torch.cuda.synchronize()
    _r1_read("estimators_draw", 1, [M * N])
    ref = _scaler_reference(A.larray)
    ends = min(4096, M // 2)  # rows at each end held against the float64 formula
    sample = torch.cat([torch.arange(ends, device=dev), torch.arange(M - ends, M, device=dev)])
    for s in _scalers(ht, A, ref, sample, "scalers", EST_REPS, launches):
        row(f"scaler_{s['name']}", s["ms"], s["bytes"], 0.0, max(s["errs"].values()), TOL_EST, {"K4": s["k4"]},
            errs=s["errs"], what="fit + transform + inverse (Normalizer: fit + transform), 65536x8192 float32 split 0")
    launches["RobustScaler_k4"] = launches.pop("RobustScaler")
    _require(launches["RobustScaler_k4"] >= 1, "RobustScaler's fit launched no K4")
    _lane_sort_routes(A.larray, row)
    del A, ref
    torch.cuda.empty_cache()

    ops = _est_operands(dev)
    x, labels, y = ops["x"], ops["labels"], ops["y"]
    X, Y = ht.array(x, split=0), ht.array(labels, split=0)
    xb = 4.0 * x.numel()

    # GaussianNB
    model = ht.naive_bayes.GaussianNB().fit(X, Y)
    theta64, var64 = _nb_reference(x, labels, KM_K)
    errs = {"theta": _est_rel(model.theta_.larray, theta64), "var": _est_rel(model.var_.larray - model.epsilon_, var64)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    P = model.predict_proba(X)
    pred = model.predict(X)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    errs["proba_sum"] = float((P.larray.sum(1) - 1).abs().max())
    wrong = int((pred.larray != labels).sum())
    _require(errs["theta"] <= TOL_NB and errs["var"] <= TOL_NB and errs["proba_sum"] <= 1e-5 and wrong <= 1e-5 * KM_N,
             f"GaussianNB: {errs} (tol {TOL_NB}), {wrong} rows mislabelled")
    _require(peak <= NB_PEAK * xb, f"GaussianNB.predict allocated {peak} B at its peak, over {NB_PEAK} x X")
    del P, pred
    fit_ms = _median_ms(lambda: ht.naive_bayes.GaussianNB().fit(X, Y), EST_REPS)
    proba_ms = _median_ms(lambda: model.predict_proba(X), EST_REPS)
    pred_ms = _median_ms(lambda: model.predict(X), EST_REPS)
    nb_flops = 4.0 * x.numel() * KM_K  # a subtraction, a square, a division and an add a feature and class
    row("gaussian_nb_fit", fit_ms, xb + 8.0 * KM_N, 4.0 * x.numel() * KM_K, max(errs["theta"], errs["var"]), TOL_NB,
        errs=errs)
    row("gaussian_nb_predict_proba", proba_ms, xb + 4.0 * KM_N * KM_K, nb_flops, errs["proba_sum"], 1e-5,
        peak_bytes=peak, x_bytes=xb)
    row("gaussian_nb_predict", pred_ms, xb + 8.0 * KM_N, nb_flops, wrong / KM_N, 1e-5)
    del model
    torch.cuda.empty_cache()

    # Lasso: θ against a float64 fit of the same data (NumPy's sweeps on a float64 Gram)
    Yl = ht.array(y, split=0)
    tlasso.HOST_READS = 0
    lasso = ht.regression.Lasso(lam=LASSO_LAM).fit(X, Yl)
    sweeps, reads = lasso.n_iter, tlasso.HOST_READS
    g = torch.zeros((KM_D + 1, KM_D + 2), dtype=torch.float64, device=dev)
    for s in range(0, KM_N, 1 << 22):
        blk = torch.cat([torch.ones((min(1 << 22, KM_N - s), 1), dtype=torch.float64, device=dev),
                         x[s : s + (1 << 22)].double(), y[s : s + (1 << 22), None].double()], dim=1)
        g += blk[:, : KM_D + 1].T @ blk
    g = (g / KM_N).cpu().numpy()
    th_ref, it_ref = _lasso_reference(g[:, :-1], g[:, -1], LASSO_LAM, 1e-6, 100)
    th = lasso.theta.larray.reshape(-1).double().cpu().numpy()
    err = float(np.abs(th - th_ref).max() / np.abs(th_ref).max())
    truth = float((lasso.theta.larray.reshape(-1) - ops["theta"]).abs().max())
    _require(err <= TOL_LASSO and reads == sweeps and truth <= 0.02,
             f"Lasso: θ rel {err:.3e} (tol {TOL_LASSO}), host reads {reads} for {sweeps} sweeps, |θ − θ*| {truth:.3e}")
    lasso_ms = _median_ms(lambda: ht.regression.Lasso(lam=LASSO_LAM).fit(X, Yl), EST_REPS)
    gram = tlasso._gram(x, y) / KM_N
    sweep_ms = _median_ms(lambda: tlasso._sweeps(gram[:, :-1], gram[:, -1], LASSO_LAM, 1e-6, 100), EST_REPS) / sweeps
    pred_ms = _median_ms(lambda: lasso.predict(X), EST_REPS)
    m = KM_D + 1
    row("lasso_fit", lasso_ms, xb + 4.0 * KM_N, 2.0 * KM_N * m * (m + 1), err, TOL_LASSO, sweeps=sweeps,
        reference_sweeps=it_ref, ms_a_sweep=sweep_ms, host_reads=reads, theta_star_err=truth)
    row("lasso_predict", pred_ms, xb + 4.0 * KM_N, 2.0 * x.numel(), 0.0, 0.0)
    del lasso, gram, Yl, X, Y
    torch.cuda.empty_cache()

    # KNN: 65536 training rows, 16384 queries, k = 5, against a float64 vote
    xt, yt, xq = ops["xt"], ops["yt"], ops["xq"]
    knn = ht.classification.KNeighborsClassifier(KNN_K).fit(ht.array(xt, split=0), ht.array(yt, split=0))
    Q = ht.array(xq, split=0)
    got = knn.predict(Q).larray
    want = _knn_reference(xq, xt, yt, KNN_K, KM_K)
    differ = int((got != want).sum())
    _require(differ == 0, f"KNN: {differ} labels differ from the float64 vote with (distance, index) ties")
    knn_ms = _median_ms(lambda: knn.predict(Q), 1)  # seconds a call (torch.cdist's direct form)
    dist_ms = _median_ms(lambda: [tdist._direct(xq[s : s + tknn._QUERY_BLOCK], xt)
                                  for s in range(0, KNN_Q, tknn._QUERY_BLOCK)], 1)
    row("knn_predict", knn_ms, 4.0 * (xt.numel() + xq.numel()) + 8.0 * KNN_Q, 3.0 * KNN_Q * KNN_N * KM_D, differ, 0,
        distance_ms=dist_ms, distance_share=dist_ms / knn_ms)
    del knn, Q, got, want

    # Laplacian and Spectral: 8 blobs of 4096 rows, n_lanczos = 300
    xs = ops["xs"]
    S_in = ht.array(xs, split=0)
    model = ht.cluster.Spectral(n_clusters=SPEC_K, gamma=SPEC_GAMMA, n_lanczos=SPEC_LANCZOS)
    lap_ms = _median_ms(lambda: model._laplacian.construct(S_in), EST_REPS)
    torch.cuda.empty_cache()
    ht.random.seed(EST_SEED)
    ca.ASSIGN_LAUNCHES = 0
    _r1_zero()
    facts.HOST_READS = 0
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    model.fit(S_in)
    stop.record()
    torch.cuda.synchronize()
    spec_ms = start.elapsed_time(stop)
    k3, reads = ca.ASSIGN_LAUNCHES, facts.HOST_READS
    r1 = _r1_read("spectral_fit", 1 + SPEC_K)
    ok = _recovered(model.labels_.larray, SPEC_K)
    _require(ok and k3 == model._cluster.n_iter_ and reads == SPEC_LANCZOS - 1,
             f"Spectral: blobs recovered {ok}, K3 launches {k3} for {model._cluster.n_iter_} Lloyd steps, "
             f"Lanczos host reads {reads}")
    launches.update({"Spectral_k3": k3, "Spectral_r1": r1["launches"]})
    nn = float(SPEC_N) ** 2
    row("laplacian", lap_ms, 2 * 4.0 * nn, 2.0 * nn * KM_D, 0.0, 0.0, what="rbf (product form), then norm_sym")
    row("spectral_fit", spec_ms, (2 + SPEC_LANCZOS) * 4.0 * nn, 2.0 * nn * KM_D + 2.0 * SPEC_LANCZOS * nn,
        0.0, 0.0, {"K3": k3, "R1": r1["launches"]}, n_iter=model._cluster.n_iter_, lanczos_host_reads=reads,
        recovered=ok)
    del model, S_in
    torch.cuda.empty_cache()

    # spectral_embedding on pagerank_2m's graph, symmetrised
    graph = inputs["graph"]
    sym = (graph + graph.T).tocsr().astype(np.float32)
    S = ht.sparse.sparse_dbcsr_matrix(sym, split=0)
    n = sym.shape[0]
    ks.SPMM_LAUNCHES = 0
    ev, emb = ht.graph.spectral_embedding(S, EMB_K, m=EMB_M)
    torch.cuda.synchronize()
    k7 = ks.SPMM_LAUNCHES
    bd, bc, br, bm = S._phys_components
    bd64 = bd.double()
    deg = ks.brick_spmm_plain(bd64, bc, br, bm, torch.ones((n, 1), dtype=torch.float64, device=dev), n)[:, 0]
    dvec = torch.where(deg > 0, 1.0 / torch.sqrt(deg.clamp_min(1e-30)), torch.zeros((), dtype=torch.float64, device=dev))
    mv = lambda v: v - ks.brick_spmm_plain(bd64, bc, br, bm, (v * dvec)[:, None], n)[:, 0] * dvec  # noqa: E731
    v0 = np.random.default_rng(0x5BED).standard_normal(n).astype(np.float32)
    v0 = torch.from_numpy(v0 / np.linalg.norm(v0)).to(dev)
    V, al, be = solver._lanczos_operator(mv, n, EMB_M, v0, torch.float64)
    a_, b_ = al.cpu().numpy(), be.cpu().numpy()
    evals, evecs = np.linalg.eigh(np.diag(a_) + np.diag(b_[1:], 1) + np.diag(b_[1:], -1))
    emb_ref = V @ torch.from_numpy(evecs[:, :EMB_K]).to(dev)
    got = emb.larray.double()
    sign = torch.sign((got * emb_ref).sum(0))
    errs = {"ritz": float(np.abs(ev - evals[:EMB_K]).max()), "embedding": float((got * sign - emb_ref).abs().max())}
    _require(k7 == 1 + EMB_M and max(errs.values()) <= TOL_EMB,
             f"spectral_embedding: K7 launches {k7} (want {1 + EMB_M}), errors {errs} (tol {TOL_EMB})")
    launches["embedding_k7"] = k7
    emb_ms = _median_ms(lambda: ht.graph.spectral_embedding(S, EMB_K, m=EMB_M), EST_REPS)
    nbytes = 4096 * S.slab_bricks + 12 * S.slab_bricks + 4 * (S.mb + 1) + 8 * n
    row("spectral_embedding", emb_ms, (1 + EMB_M) * nbytes, (1 + EMB_M) * 2.0 * 1024 * S._slab_meta[0][2],
        max(errs.values()), TOL_EMB, {"K7": k7}, errs=errs, ritz=[float(v) for v in ev], nodes=n,
        edges=int(sym.nnz), bricks=int(S._slab_meta[0][2]))
    del S, emb, V, emb_ref, bd64
    torch.cuda.empty_cache()

    WORLD_REFERENCE["estimators"] = _world_estimators_reference(ht, dev)
    print(f"estimator launches: {launches}", flush=True)
    return {"rows": rows, "launches": launches}


def _world_estimators_reference(ht, dev) -> dict:
    """World size 1's results on the world's operands (1/WORLD_EST_DIV of
    the rows), for ``_world_estimators``."""
    import torch

    ops = _est_operands(dev, WORLD_EST_DIV)
    gen = torch.Generator(device=dev)
    gen.manual_seed(EST_SEED + 1)
    a = torch.randn(M // WORLD_EST_DIV, N, device=dev, generator=gen)
    out = {"scalers": {}}
    for split in (0, 1):
        A = ht.array(a, split=split)
        for name in ("StandardScaler", "MinMaxScaler", "MaxAbsScaler", "RobustScaler"):
            stats = _scaler_stats(name, getattr(ht.preprocessing, name)().fit(A))
            out["scalers"][(name, split)] = {k: v.cpu() for k, v in stats.items()}
    X, Y = ht.array(ops["x"], split=0), ht.array(ops["labels"], split=0)
    nb = ht.naive_bayes.GaussianNB().fit(X, Y)
    out["nb"] = (nb.theta_.larray.cpu(), nb.var_.larray.cpu(), nb.predict(X).larray.to(torch.int8).cpu())
    la = ht.regression.Lasso(lam=LASSO_LAM).fit(X, ht.array(ops["y"], split=0))
    out["lasso"] = (la.theta.larray.cpu(), la.n_iter)
    knn = ht.classification.KNeighborsClassifier(KNN_K).fit(ht.array(ops["xt"], split=0), ht.array(ops["yt"], split=0))
    out["knn"] = knn.predict(ht.array(ops["xq"], split=0)).larray.cpu()
    ht.random.seed(EST_SEED)
    sp_model = ht.cluster.Spectral(n_clusters=SPEC_K, gamma=SPEC_GAMMA, n_lanczos=SPEC_LANCZOS).fit(
        ht.array(ops["xs"], split=0))
    out["spectral"] = sp_model.labels_.larray.cpu()
    torch.cuda.empty_cache()
    return out


def _world_estimators(ht, comm, moved: dict, rank: int, dev) -> dict:
    """The estimators across the ranks on the world's operands (every rank
    draws them whole from the same seed, keeps its chunk): the scalers on
    8192 x 8192 split 0 and split 1, GaussianNB, Lasso, KNN and Spectral
    on 1/WORLD_EST_DIV of world size 1's rows, split 0; each held to world
    size 1's results (``WORLD_REFERENCE``), with its time and the
    collectives and bytes a rank."""
    import torch

    from heat_tpu_torch.kernels import sort as ks

    ref = WORLD_REFERENCE["estimators"]
    ops = _est_operands(dev, WORLD_EST_DIV)
    gen = torch.Generator(device=dev)
    gen.manual_seed(EST_SEED + 1)
    a = torch.randn(M // WORLD_EST_DIV, N, device=dev, generator=gen)
    out = {}

    def measured(name, fn, reps=2):
        """``fn()``'s result, its collectives, bytes a rank and K4 launches
        (of that one call), and the median time of the counted call and
        ``reps`` − 1 more."""
        comm.counts.clear()
        moved.clear()
        ks.SORT_LAUNCHES = 0
        kept = []
        times = [_world_ms(lambda: kept.append(fn()), 1)]
        out[name] = {"counts": dict(comm.counts), "bytes": dict(moved), "k4": ks.SORT_LAUNCHES}
        times += [_world_ms(fn, 1) for _ in range(reps - 1)]
        out[name]["ms"] = statistics.median(times)
        return kept[0]

    for split in (0, 1):
        A = ht.array(a, split=split)
        for name in ("StandardScaler", "MinMaxScaler", "MaxAbsScaler", "RobustScaler"):
            model = measured(f"{name}_{split}", lambda: getattr(ht.preprocessing, name)().fit(A))
            stats = _scaler_stats(name, model)
            err = max(_est_rel(v, ref["scalers"][(name, split)][k]) for k, v in stats.items())
            back = model.inverse_transform(model.transform(A))
            trip = float(comm.allreduce((back.larray - A.larray).abs().max().reshape(1), "max")[0])
            k4 = out[f"{name}_{split}"]["k4"]
            _every_rank_ok(comm, err <= TOL_WORLD_EST and trip <= TOL_EST * 8 and (name != "RobustScaler" or k4 >= 1),
                           f"{name} split {split} across ranks: statistics rel {err:.3e} against world size 1, "
                           f"round trip {trip:.3e}, K4 launches {k4}")
            out[f"{name}_{split}"]["err"] = err
    X, Y = ht.array(ops["x"], split=0), ht.array(ops["labels"], split=0)
    counts_r, displs = X.counts_displs()
    mine = slice(displs[rank], displs[rank] + counts_r[rank])
    nb = measured("gaussian_nb_fit", lambda: ht.naive_bayes.GaussianNB().fit(X, Y))
    theta, var, pred = ref["nb"]
    err = max(_est_rel(nb.theta_.larray, theta), _est_rel(nb.var_.larray, var))
    same = torch.equal(nb.predict(X).larray.cpu().to(torch.int8), pred[mine])
    _every_rank_ok(comm, err <= TOL_WORLD_EST and same, f"GaussianNB across ranks: θ/var rel {err:.3e}, labels {same}")
    out["gaussian_nb_fit"]["err"] = err
    Yl = ht.array(ops["y"], split=0)
    la = measured("lasso_fit", lambda: ht.regression.Lasso(lam=LASSO_LAM).fit(X, Yl))
    theta, it = ref["lasso"]
    err = _est_rel(la.theta.larray, theta)
    _every_rank_ok(comm, err <= TOL_WORLD_EST and la.n_iter == it and out["lasso_fit"]["counts"] == {"all-reduce": 1},
                   f"Lasso across ranks: θ rel {err:.3e}, sweeps {la.n_iter} against {it}, collectives "
                   f"{out['lasso_fit']['counts']}")
    out["lasso_fit"].update({"err": err, "sweeps": la.n_iter})
    del X, Y, Yl
    xt, yt = ht.array(ops["xt"], split=0), ht.array(ops["yt"], split=0)
    Q = ht.array(ops["xq"], split=0)
    knn = ht.classification.KNeighborsClassifier(KNN_K).fit(xt, yt)
    got = measured("knn_predict", lambda: knn.predict(Q))
    qc, qd = Q.counts_displs()
    same = torch.equal(got.larray.cpu(), ref["knn"][qd[rank] : qd[rank] + qc[rank]])
    _every_rank_ok(comm, same, "KNN across ranks: labels differ from world size 1's")
    S_in = ht.array(ops["xs"], split=0)

    def spectral():
        ht.random.seed(EST_SEED)
        return ht.cluster.Spectral(n_clusters=SPEC_K, gamma=SPEC_GAMMA, n_lanczos=SPEC_LANCZOS).fit(S_in)

    sp_model = measured("spectral_fit", spectral, reps=1)
    labels = sp_model.labels_.resplit(None).larray.cpu()
    want = ref["spectral"]
    pairs = len(set(zip(labels.tolist(), want.tolist())))
    _every_rank_ok(comm, pairs == SPEC_K == len(set(want.tolist())),
                   f"Spectral across ranks: labels are no permutation of world size 1's ({pairs} label pairs)")
    return out


def _report_world_estimators(per: list, shared: str) -> dict:
    for name in per[0]:
        e = per[0][name]
        extra = {k: v for k, v in e.items() if k not in ("counts", "bytes", "ms")}
        print(
            f"world estimators {name}: {e['ms']:.4f} ms a call (rank 0, median; ranks "
            f"{[round(p[name]['ms'], 4) for p in per]}), against world size 1 {extra}; collectives a rank "
            f"{e['counts']}, bytes a rank put in {e['bytes']}; {shared}", flush=True,
        )
    return {name: {"k4": [p[name].get("k4") for p in per], "counts": per[0][name]["counts"]} for name in per[0]}


# --------------------------------------------------------------------- #
# the sparse engine and I/O across ranks                                #
# --------------------------------------------------------------------- #
WORLD_SPARSE_SEED = 9400  # the seed of the world sparse phase's dense operands
CARD_BLOCK = 1024  # brick rows whose values card_slab draws from one seed
IO_SEED = 9500
IO_ROWS, IO_COLS = 1 << 18, 16  # the CSV row: a split-0 float32 array of 2^18 x 16
IO_BIG = (1 << 24, 16)  # 1 GiB of float32, split 0, checkpointed
ONEHOT = (1 << 20, 8, 100)  # rows, integer features, categories a feature
WORLD_DIR = {}  # "dir": the world's shared directory (set in each worker)
CARD_LINE = {}  # "card": nvidia-smi's name and power limit, printed beside each time


def card_slab(dev, ht, comm):
    """The card-scale brick matrix of the world phase: 131072^2 with
    1,048,576 bricks at card_matrix's positions (one randperm from
    SPARSE_SEED), each block of CARD_BLOCK brick rows drawing its bricks'
    values from its own seed, so that a rank draws only the blocks its
    slab meets; this rank's slab (all of it at world size 1) through the
    raw constructor."""
    import torch

    from heat_tpu_torch.sparse.dbcsr_matrix import _block_extent, _slab_layout

    gen = torch.Generator(device=dev)
    gen.manual_seed(SPARSE_SEED)
    mb, nb = CARD_N // 8, CARD_N // 128
    lin = torch.sort(torch.randperm(mb * nb, device=dev, generator=gen)[:CARD_BRICKS]).values
    brow_all, bcol_all = (lin // nb).to(torch.int32), (lin % nb).to(torch.int32)
    del lin
    ptr = torch.searchsorted(brow_all, torch.arange(mb + 1, dtype=torch.int32, device=dev), out_int32=True).tolist()
    p = comm.size
    me = comm.rank
    meta = tuple((g0, g1, ptr[g1] - ptr[g0]) for g0, g1 in _slab_layout(CARD_N, mb, p))
    g0, g1, _ = meta[me]
    t0, t1 = ptr[g0], ptr[g1]
    parts = []
    for b in range(g0 // CARD_BLOCK, -(-g1 // CARD_BLOCK)):
        lo, hi = ptr[b * CARD_BLOCK], ptr[min((b + 1) * CARD_BLOCK, mb)]
        gb = torch.Generator(device=dev)
        gb.manual_seed(SPARSE_SEED + 1 + b)
        block = torch.randn(hi - lo, 8, 128, device=dev, generator=gb)
        parts.append(block[max(t0, lo) - lo : min(t1, hi) - lo])
        del block
    bdata = torch.cat(parts)
    del parts
    brow, bcol = brow_all[t0:t1].contiguous(), bcol_all[t0:t1].contiguous()
    c = _block_extent(CARD_N, p)
    rows = brow.long()[:, None] * 8 + torch.arange(8, device=dev)
    bmask = (rows >= me * c) & (rows < (me + 1) * c)
    first = max([0] + [m1 for _, m1, _ in meta[:me]])
    nnz = torch.count_nonzero(bdata[brow >= first]).reshape(1)
    gnnz = int(comm.allreduce(nnz).item()) if p > 1 else int(nnz.item())
    return ht.sparse.DBCSR_matrix(bdata, bcol, brow, bmask, meta, gnnz, CARD_BRICKS, (CARD_N, CARD_N), ht.float32,
                                  0, ht.gpu, comm)


def _sparse_operands(dev):
    """The world sparse phase's dense operands from WORLD_SPARSE_SEED, whole:
    x for spmm_1gb (SPMM_N, SPMM_K), u and v for its sddmm (SDDMM_D), x for
    the card matrix (CARD_N, SPMM_K)."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(WORLD_SPARSE_SEED)
    return {"x": torch.randn(SPMM_N, SPMM_K, device=dev, generator=gen),
            "u": torch.randn(SPMM_N, SDDMM_D, device=dev, generator=gen),
            "v": torch.randn(SPMM_N, SDDMM_D, device=dev, generator=gen),
            "xc": torch.randn(CARD_N, SPMM_K, device=dev, generator=gen)}


def _symmetrised(graph):
    return (graph + graph.T).tocsr().astype("float32")


def world_sparse_reference(dev, inputs: dict) -> None:
    """World size 1's results of the calls the world sparse phase makes,
    for ``_world_sparse`` (``WORLD_REFERENCE["sparse"]``): S @ x and sddmm
    at spmm_1gb, the card matrix's S @ x, PageRank and spectral_embedding,
    with the |A|·|x| scales of the products."""
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.kernels import spmm as ks

    ops = _sparse_operands(dev)
    S = ht.sparse.sparse_dbcsr_matrix(inputs["bsr"], split=0)
    bd, bc, br, bm = S._phys_components
    ref = {"y": (S @ ops["x"]).larray.cpu(),
           "y_scale": ks.brick_spmm_plain(bd.abs(), bc, br, bm, ops["x"].abs(), SPMM_N).cpu(),
           "sddmm": ht.sparse.sddmm(S, ops["u"], ops["v"])._phys_components[0].cpu(),
           "rowptr": S._brick_rowptr.cpu()}
    del S, bd, bc, br, bm
    C = card_slab(dev, ht, ht.get_comm())
    bd, bc, br, bm = C._phys_components
    ref["yc"] = (C @ ops["xc"]).larray.cpu()
    ref["yc_scale"] = ks.brick_spmm_plain(bd.abs(), bc, br, bm, ops["xc"].abs(), CARD_N).cpu()
    del C, bd, bc, br, bm, ops
    torch.cuda.empty_cache()
    res = ht.graph.pagerank(inputs["graph"], tol=PR_TOL)
    ref["pagerank"] = (res.ranks.larray.cpu(), res.iterations)
    ev, emb = ht.graph.spectral_embedding(ht.sparse.sparse_dbcsr_matrix(_symmetrised(inputs["graph"]), split=0),
                                          EMB_K, m=EMB_M)
    ref["embedding"] = (torch.from_numpy(ev), emb.larray.cpu())
    WORLD_REFERENCE["sparse"] = ref
    torch.cuda.empty_cache()


def _touched_columns(S) -> int:
    """The columns of the matrix that this rank's slab's real bricks meet:
    the rows of x (K7) or v (K8) that its kernel must read."""
    import torch

    cols = torch.unique(S._phys_components[1][: S._nreal]).long()
    return int(torch.clamp(S.shape[1] - 128 * cols, max=128).sum())


def _slab_bound(S, k: int):
    """(bytes, operations) of K7 on this rank's slab: the bricks, their
    indices and masks, the slab's row pointer, the rows of x at the slab's
    brick columns and the rank's rows of y once; 2·1024·k operations a
    real brick."""
    B, nreal = S.slab_bricks, S._nreal
    g0, g1 = S._slab_rows
    rows = S.lshape[0]
    return 4096 * B + 12 * B + 4 * (g1 - g0 + 1) + 4 * k * (_touched_columns(S) + rows), 2.0 * 1024 * nreal * k


def _world_sparse(ht, comm, moved: dict, rank: int, dev) -> dict:
    """The sparse engine across the ranks: spmm_1gb's BSR split 0 (each rank
    its slab from the whole host matrix), S @ x with x whole and split 0 and
    sddmm(S, u, v); the card matrix, each rank drawing only its slab on the
    card, S @ x at k = 4; pagerank_2m split 0; spectral_embedding of a split
    DBCSR. Each held to world size 1's result (``WORLD_REFERENCE["sparse"]``)
    within the path's limits, with K7/K8 launches, collectives and bytes a
    rank and the call time; then K7 and K8 alone on each rank's slab beside
    their plain versions and the library call, for the kernel rows."""
    import pickle

    import numpy as np
    import torch

    from heat_tpu_torch.graph.pagerank import _operator
    from heat_tpu_torch.kernels import spmm as ks

    ref = WORLD_REFERENCE["sparse"]
    with open(ref["inputs"], "rb") as f:
        inputs = pickle.load(f)
    ops = _sparse_operands(dev)
    out, rows = {}, {}

    def measured(name, fn, reps=3):
        comm.counts.clear()
        moved.clear()
        ks.SPMM_LAUNCHES = ks.SDDMM_LAUNCHES = ks.SDDMM_SM90_LAUNCHES = 0
        kept = []
        times = [_world_ms(lambda: kept.append(fn()), 1)]
        out[name] = {"counts": dict(comm.counts), "bytes": dict(moved), "k7": ks.SPMM_LAUNCHES,
                     "k8": ks.SDDMM_LAUNCHES, "k8_sm90": ks.SDDMM_SM90_LAUNCHES}
        times += [_world_ms(fn, 1) for _ in range(reps - 1)]
        out[name]["ms"] = statistics.median(times)
        return kept[0]

    def held(name, y, want, scale, tol=TOL_SPARSE):
        err = float((y.double() - want.double()).abs().max()) if y.numel() else 0.0
        ok = bool(((y.double() - want.double()).abs() <= tol * scale.double()).all())
        out[name]["err"] = err
        return ok

    t0 = time.perf_counter()
    S = ht.sparse.sparse_dbcsr_matrix(inputs["bsr"], split=0)
    out["host_build_s"] = time.perf_counter() - t0
    r0, r1 = S._row_block
    x = ops["x"]
    y = measured("spmm_1gb_x_whole", lambda: S @ x)
    ok = held("spmm_1gb_x_whole", y.larray, ref["y"][r0:r1].to(dev), ref["y_scale"][r0:r1].to(dev))
    _every_rank_ok(comm, ok and out["spmm_1gb_x_whole"]["k7"] == 1 and out["spmm_1gb_x_whole"]["counts"] == {},
                   f"world spmm_1gb S @ x (x whole): {out['spmm_1gb_x_whole']}")
    X = ht.array(x, split=0)
    y = measured("spmm_1gb_x_split", lambda: S @ X)
    ok = held("spmm_1gb_x_split", y.larray, ref["y"][r0:r1].to(dev), ref["y_scale"][r0:r1].to(dev))
    _every_rank_ok(comm, ok and out["spmm_1gb_x_split"]["k7"] == 1
                   and out["spmm_1gb_x_split"]["counts"] == {"all-gather": 1},
                   f"world spmm_1gb S @ x (x split 0): {out['spmm_1gb_x_split']}")
    u, v = ops["u"], ops["v"]
    C = measured("sddmm_1gb", lambda: ht.sparse.sddmm(S, u, v))
    sd, bc, br, _ = S._phys_components
    g0, g1 = S._slab_rows
    rowptr = ref["rowptr"].tolist()
    nreal = S._nreal
    want = ref["sddmm"][rowptr[g0] : rowptr[g1]].to(dev)
    scale = ks.brick_sddmm_plain(sd[:nreal].abs(), br[:nreal], bc[:nreal], u.abs(), v.abs())
    ok = held("sddmm_1gb", C._phys_components[0][:nreal], want, scale)
    e = out["sddmm_1gb"]
    _every_rank_ok(comm, ok and e["k8"] == 1 and e["k8_sm90"] == 1 and e["counts"] == {},
                   f"world sddmm at spmm_1gb: {e}")
    del C, want, scale
    rows["spmm_1gb"] = _world_k7_times(ht, comm, rank, S, x)
    rows["sddmm_1gb"] = _world_k8_times(comm, rank, S, u, v)
    del S, X, y
    torch.cuda.empty_cache()

    Cm = card_slab(dev, ht, comm)
    r0, r1 = Cm._row_block
    xc = ops["xc"]
    y = measured("card_k4", lambda: Cm @ xc)
    ok = held("card_k4", y.larray, ref["yc"][r0:r1].to(dev), ref["yc_scale"][r0:r1].to(dev))
    _every_rank_ok(comm, ok and out["card_k4"]["k7"] == 1 and out["card_k4"]["counts"] == {},
                   f"world card matrix S @ x: {out['card_k4']}")
    rows["card_k4"] = _world_k7_times(ht, comm, rank, Cm, xc)
    del Cm, y
    torch.cuda.empty_cache()

    graph = inputs["graph"]
    res = measured("pagerank", lambda: ht.graph.pagerank(graph, tol=PR_TOL), reps=1)
    ranks_ref, iters = ref["pagerank"]
    p0 = comm.chunk((PR_N,), 0)[0]
    err = float((res.ranks.larray.cpu() - ranks_ref[p0 : p0 + res.ranks.lshape[0]]).abs().max())
    e = out["pagerank"]
    e.update({"err": err, "iterations": res.iterations})
    _every_rank_ok(comm, res.iterations == iters and err <= TOL_RANKS and e["k7"] == iters
                   and e["counts"] == {"all-gather": 1 + iters},  # the slabs' brick counts, then one a step
                   f"world PageRank: {res.iterations} iterations against world size 1's {iters}, ranks off by {err:.3e}, "
                   f"{e}")
    M, _ = _operator(graph, 0, None, comm)
    rows["pagerank"] = _world_k7_times(ht, comm, rank, M, res.ranks.comm.allgather(res.ranks.larray)[:, None]
                                       .contiguous())
    del M, res
    sym = _symmetrised(graph)
    A = ht.sparse.sparse_dbcsr_matrix(sym, split=0)
    ev, emb = measured("spectral_embedding", lambda: ht.graph.spectral_embedding(A, EMB_K, m=EMB_M), reps=1)
    ev_ref, emb_ref = ref["embedding"]
    r0, r1 = A._row_block
    want = emb_ref[r0:r1].to(dev).double()
    got = emb.larray.double()
    sign = torch.sign(comm.allreduce((got * want).sum(0)))
    errs = {"ritz": float(np.abs(ev - ev_ref.numpy()).max()),
            "embedding": float((got * sign - want).abs().max()) if got.numel() else 0.0}
    e = out["spectral_embedding"]
    e.update({"err": max(errs.values()), "errs": errs})
    _every_rank_ok(comm, max(errs.values()) <= TOL_EMB and e["k7"] == 1 + EMB_M,
                   f"world spectral_embedding: {errs} (tol {TOL_EMB}), {e}")
    v1 = torch.randn(PR_N, 1, device=dev, generator=torch.Generator(device=dev).manual_seed(WORLD_SPARSE_SEED + 1))
    rows["spectral_embedding"] = _world_k7_times(ht, comm, rank, A, v1)
    del A, emb
    torch.cuda.empty_cache()
    out["rows"] = rows
    return out


def _world_k7_times(ht, comm, rank: int, S, x) -> dict:
    """K7 on this rank's slab of S, alone (the other ranks at a barrier):
    its CUDA-event median, the plain version's and the library call's on
    the same slab (checked to agree on the rank's rows first), and the
    slab's bound."""
    from heat_tpu_torch.kernels import spmm as ks

    bdata, bcol, brow, bmask = S._phys_components
    (g0, _), (r0, r1) = S._slab_rows, S._row_block
    rowptr = S._brick_rowptr
    call = lambda: ks.brick_spmm(bdata, bcol, brow, bmask, rowptr, x, r1 - r0, g0=g0, r0=r0)  # noqa: E731
    plain = lambda: ks.brick_spmm_plain(bdata, bcol, brow, bmask, x, r1 - r0, r0)  # noqa: E731
    name, lib = _library_spmm(S, x, quiet=True)
    y, y_plain, y_lib = call(), plain(), lib()
    y_lib = y_lib[r0 - 8 * g0 : r1 - 8 * g0]  # the slab's brick rows hold the rank's rows from r0 - 8·g0
    scale = ks.brick_spmm_plain(bdata.abs(), bcol, brow, bmask, x.abs(), r1 - r0, r0)
    _every_rank_ok(comm, bool(((y - y_plain).abs() <= TOL_SPARSE * scale).all()),
                   "K7 with a row offset disagrees with its plain version on the slab")
    _every_rank_ok(comm, bool(((y - y_lib).abs() <= TOL_SPARSE * scale).all()), f"{name} does not compute the slab's rows")
    err = float((y - y_plain).abs().max()) if y.numel() else 0.0
    del y, y_plain, y_lib, scale
    nbytes, flops = _slab_bound(S, x.shape[1])
    return {"ms": _alone(rank, call, 10), "plain_ms": _alone(rank, plain, 2), "library_ms": _alone(rank, lib, 5),
            "library": name, "bytes": nbytes, "flops": flops, "bricks": S._nreal, "plain_err": err}


def _world_k8_times(comm, rank: int, S, u, v) -> dict:
    """K8 on this rank's slab, alone: its CUDA-event median, the plain
    version's and torch.sparse.sampled_addmm's on a CSR mask of the slab's
    nonzeros, and the slab's bound."""
    import torch

    from heat_tpu_torch.kernels import spmm as ks

    sdata, bcol, brow, _ = S._phys_components
    colorder = S._brick_colorder
    g0, g1 = S._slab_rows
    csr, _ = _csr_of(S, sdata.device)
    ub = u[8 * g0 : 8 * g1]  # the slab's brick rows of u: the CSR mask's rows
    vt = v.T
    B = S.slab_bricks
    d = u.shape[1]
    call = lambda: ks.brick_sddmm(sdata, brow, bcol, *colorder, u, v)  # noqa: E731
    plain = lambda: ks.brick_sddmm_plain(sdata, brow, bcol, u, v)  # noqa: E731
    c, c_plain = call(), plain()
    scale = ks.brick_sddmm_plain(sdata.abs(), brow, bcol, u.abs(), v.abs())
    _every_rank_ok(comm, bool(((c - c_plain).abs() <= TOL_SPARSE * scale).all()),
                   "K8 disagrees with its plain version on the slab")
    err = float((c - c_plain).abs().max())
    del c, c_plain, scale
    # u's rows of the slab's brick rows and v's at its brick columns, once
    uv_rows = ub.shape[0] + _touched_columns(S)
    return {"ms": _alone(rank, call, 10), "plain_ms": _alone(rank, plain, 2), "plain_err": err,
            "library_ms": _alone(rank, lambda: torch.sparse.sampled_addmm(csr, ub, vt, beta=0.0), 5),
            "bytes": 2 * 4096 * B + 8 * B + 4 * d * uv_rows, "flops": 1024.0 * B * (2 * d + 1),
            "bricks": S._nreal}


def _report_world_sparse(per: list, shared: str) -> list:
    """Print the sparse phase of the world; returns its kernel rows."""
    card = CARD_LINE.get("card", "")
    what = {"spmm_1gb_x_whole": f"spmm_1gb S ({SPMM_N}^2, split 0) @ x ({SPMM_N}, {SPMM_K}) whole",
            "spmm_1gb_x_split": f"spmm_1gb S @ x split 0 (one all-gather of x)",
            "sddmm_1gb": f"sddmm(S, u, v) at spmm_1gb, d = {SDDMM_D}, u and v whole",
            "card_k4": f"card matrix ({CARD_N}^2, {CARD_BRICKS} bricks, each rank drawing its slab) S @ x, k = {SPMM_K}",
            "pagerank": f"ht.graph.pagerank(pagerank_2m, tol={PR_TOL}) split 0",
            "spectral_embedding": f"spectral_embedding(pagerank_2m symmetrised, DBCSR split 0, k={EMB_K}, m={EMB_M})"}
    for name, label in what.items():
        each = [p[name] for p in per]
        print(
            f"world sparse {name}: {label}: {each[0]['ms']:.4f} ms a call (rank 0; ranks "
            f"{[round(e['ms'], 4) for e in each]}); K7 launches a rank {[e['k7'] for e in each]}, K8 "
            f"{[e['k8'] for e in each]} (Hopper {[e['k8_sm90'] for e in each]}); against world size 1 max |Δ| "
            f"{max(e['err'] for e in each):.3e}"
            + (f", {each[0]['iterations']} iterations (world size 1's)" if name == "pagerank" else "")
            + f"; collectives a rank {each[0]['counts']}, bytes a rank put in {[e['bytes'] for e in each]}; "
            f"{shared}; {card}", flush=True,
        )
    print(f"world sparse: spmm_1gb's host build (sparse_dbcsr_matrix from the whole BSR, each rank blocking its "
          f"slab's rows) "
          f"{[round(p['host_build_s'], 2) for p in per]} s a rank", flush=True)
    rows = []
    spec = (("world_spmm_1gb", "spmm_1gb", "spmm_1gb_x_whole", "k7"), ("world_spmm_card", "card_k4", "card_k4", "k7"),
            ("world_pagerank", "pagerank", "pagerank", "k7"),
            ("world_spectral_embedding", "spectral_embedding", "spectral_embedding", "k7"),
            ("world_sddmm_1gb", "sddmm_1gb", "sddmm_1gb", "k8"))
    for row_name, key, call, kernel in spec:
        each = [p["rows"][key] for p in per]
        nbytes, flops = sum(e["bytes"] for e in each), sum(e["flops"] for e in each)
        if kernel == "k8":
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 3 * flops / TF32_FLOP_PER_S * 1e3
            bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        else:
            bound_ms, bound_by = _bound(nbytes, flops)
        launches = [p[call][kernel] for p in per]
        print(
            f"{row_name} ({'K8 sddmm_sm90.cu' if kernel == 'k8' else 'K7 spmm.cu'} on each rank's slab, bricks a rank "
            f"{[e['bricks'] for e in each]}): alone on the card {[round(e['ms'], 4) for e in each]} ms a rank "
            f"(CUDA events, host launch included), plain {[round(e['plain_ms'], 4) for e in each]} (max |Δ| against "
            f"the kernel {max(e['plain_err'] for e in each):.3e}), "
            f"{each[0].get('library', 'torch.sparse.sampled_addmm (CSR mask of the slab)')} "
            f"{[round(e['library_ms'], 4) for e in each]}; bound of the four slabs {bound_ms:.4f} ms ({bound_by}, "
            f"{nbytes / 1e9:.4f} GB); launches a rank on the path {launches}; {card}", flush=True,
        )
        rows.append({
            "name": row_name, "route": "cuda",
            "source": "heat_tpu_torch/csrc/sddmm_sm90.cu" if kernel == "k8" else "heat_tpu_torch/csrc/spmm.cu",
            "replaces": "heat_tpu/kernels/spmm.py:265" if kernel == "k8" else "heat_tpu/kernels/spmm.py:238",
            "launches": launches[0], "world_launches": launches,
            "max_abs_err": max(p[call]["err"] for p in per), "ms": each[0]["ms"], "plain_ms": each[0]["plain_ms"],
            "bound_ms": bound_ms / WORLD, "bound_by": bound_by, "library_ms": each[0]["library_ms"],
            "ms_ranks": [e["ms"] for e in each], "world_call_ms": per[0][call]["ms"],
        })
    return rows


def _host_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _file_digest(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def _state_equal(a, b) -> bool:
    """Two trees of tensors, DNDarrays and plain values equal bit for bit."""
    import torch

    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(_state_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(_state_equal(x, y) for x, y in zip(a, b))
    if hasattr(a, "larray"):
        a, b = a.larray, b.larray
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.contiguous().view(torch.uint8), b.to(a.device).contiguous().view(torch.uint8)))
    return a == b


def _train_state(ht, dev):
    """The CNN of examples/mnist.py after one SGD step with momentum on
    random images: its parameters and the optimizer's state."""
    import torch

    torch.manual_seed(IO_SEED)
    model = _cnn(ht, dev).eval()  # dropout off: the step needs no key
    opt = torch.optim.SGD(model.parameters(), lr=TRAIN_LR, momentum=0.9)
    x = torch.randn(64, 1, TRAIN_SIDE, TRAIN_SIDE, device=dev)
    loss = torch.nn.functional.cross_entropy(model(x), torch.randint(0, TRAIN_CLASSES, (64,), device=dev))
    loss.backward()
    opt.step()
    return {"model": model.state_dict(), "optimizer": opt.state_dict(), "epoch": 1}


def _io_array(dev):
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(IO_SEED)
    return torch.randn(IO_ROWS, IO_COLS, device=dev, generator=gen)


def _onehot_codes(dev):
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(IO_SEED + 1)
    rows, features, cats = ONEHOT
    return torch.randint(0, cats, (rows, features), device=dev, generator=gen) * 7 - 300


def io_path(dev) -> dict:
    """I/O at world size 1 on the card: save_csv and load_csv of a split-0
    float32 array of 2^18 x 16 (values back bit for bit, the file equal to
    np.savetxt's), a checkpoint of the CNN's training state and of a 1 GiB
    split-0 float32 array (bit for bit), and OneHotEncoder on 2^20 x 8
    integer codes (world size 1's result for ``_world_io``). HDF5 is not on
    the card's machine where h5py is not installed. Returns the times."""
    import io as _io
    import os
    import tempfile

    import numpy as np
    import torch

    import heat_tpu_torch as ht

    card = CARD_LINE.get("card", "")
    work = tempfile.mkdtemp(prefix="heat_io_")
    print(f"supports_hdf5() {ht.supports_hdf5()}", flush=True)
    out = {"dir": work}
    a = _io_array(dev)
    A = ht.array(a, split=0)
    csv = os.path.join(work, "a.csv")
    out["save_csv_ms"] = _host_ms(lambda: ht.save(A, csv))
    buf = _io.BytesIO()
    np.savetxt(buf, a.cpu().numpy(), delimiter=",", fmt="%s")
    with open(csv, "rb") as f:
        same_file = f.read() == buf.getvalue()
    B = None

    def load():
        nonlocal B
        B = ht.load(csv, split=0)
        torch.cuda.synchronize()

    out["load_csv_ms"] = _host_ms(load)
    back = B.larray.device == dev and torch.equal(B.larray.view(torch.int32), a.view(torch.int32))
    size = os.path.getsize(csv)
    print(f"io csv: ht.save of {IO_ROWS}x{IO_COLS} float32 split 0 {out['save_csv_ms']:.1f} ms, ht.load(split=0) "
          f"{out['load_csv_ms']:.1f} ms (host clock; a {size} B file, {size / out['load_csv_ms'] / 1e3:.1f} MB/s "
          f"parsed); values back bit for bit {back}; the file equal to np.savetxt's {same_file}; {card}", flush=True)
    _require(back and same_file, "CSV round trip: values or file bytes differ")
    del B
    state = _train_state(ht, dev)
    ck = os.path.join(work, "train")
    out["checkpoint_train_ms"] = _host_ms(lambda: ht.utils.save_checkpoint(ck, state))
    loaded = {}
    out["restore_train_ms"] = _host_ms(lambda: loaded.update(ht.utils.load_checkpoint(ck)))
    same_state = _state_equal(state, loaded)
    gen = torch.Generator(device=dev)
    gen.manual_seed(IO_SEED + 2)
    X = ht.array(torch.randn(IO_BIG, device=dev, generator=gen), split=0)
    ckb = os.path.join(work, "big")
    out["checkpoint_1gib_ms"] = _host_ms(lambda: ht.utils.save_checkpoint(ckb, {"x": X, "step": 7}))
    big = {}

    def restore():
        big.update(ht.utils.load_checkpoint(ckb))
        torch.cuda.synchronize()

    out["restore_1gib_ms"] = _host_ms(restore)
    same_big = _state_equal({"x": X, "step": 7}, big) and big["x"].split == 0
    gib = 4.0 * IO_BIG[0] * IO_BIG[1] / 2**30
    print(f"io checkpoint: the CNN's training state (model and SGD momentum, {sum(t.numel() for t in state['model'].values())} "
          f"parameters) saved {out['checkpoint_train_ms']:.1f} ms, restored {out['restore_train_ms']:.1f} ms, bit for bit "
          f"{same_state}; {gib:.0f} GiB float32 split 0 saved {out['checkpoint_1gib_ms']:.1f} ms "
          f"({gib * 1024 / out['checkpoint_1gib_ms'] * 1e3:.0f} MiB/s), restored {out['restore_1gib_ms']:.1f} ms "
          f"(host clock, the page cache warm), bit for bit {same_big}; {card}", flush=True)
    _require(same_state and same_big, "checkpoint round trip differs")
    del X, big, loaded
    torch.cuda.empty_cache()
    codes = ht.array(_onehot_codes(dev), split=0)
    enc = ht.preprocessing.OneHotEncoder()
    out["onehot_fit_ms"] = _host_ms(lambda: enc.fit(codes))
    D = None

    def transform():
        nonlocal D
        D = enc.transform(codes)
        torch.cuda.synchronize()

    out["onehot_transform_ms"] = _host_ms(transform)
    rows, features, cats = ONEHOT
    ok = D.shape == (rows, features * cats) and D.gnnz == rows * features
    print(f"io onehot: OneHotEncoder on {rows}x{features} codes ({cats} categories each) split 0: fit "
          f"{out['onehot_fit_ms']:.1f} ms, transform {out['onehot_transform_ms']:.1f} ms (host clock); {D.gnnz} "
          f"stored ones in a {D.shape} DCSR; {card}", flush=True)
    _require(ok, "OneHotEncoder's DCSR has the wrong shape or nnz")
    WORLD_REFERENCE["io"] = {"csv": csv, "onehot": (D.indptr.cpu(), D.indices.cpu()),
                             "categories": [torch.from_numpy(c) for c in enc.categories_]}
    return out


OOC_HBM_BYTES = 1 << 30  # HEAT_TPU_HBM_BYTES of the run that shows staging on a card smaller than A
TOL_OOC = {"sigma": 1e-4, "factors": 1e-3, "err": 1e-4}  # staged against in-memory, test_torch_hsvd.py's limits


def _pinned_rate(dev, nbytes: int, reps: int = 10) -> float:
    """The plain host-to-card copy rate in bytes/s: one pinned buffer of
    ``nbytes`` copied to the card with ``non_blocking=True``, median of
    ``reps`` under CUDA events."""
    import torch

    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    ms = _median_ms(lambda: dst.copy_(src, non_blocking=True), reps)
    return nbytes / (ms * 1e-3)


def _up_to_sign(x, ref) -> float:
    """max |x − ref| with each column of x signed to agree with ref's."""
    s = (x * ref).sum(0).sign()
    s[s == 0] = 1
    return float((x * s - ref).abs().max())


def ooc_path(dev, inputs: dict) -> dict:
    """Out-of-core staging on the card (``redistribution.staging``): the
    north-star operand as a ``HostArray`` in host memory, ``hsvd_rank`` both
    forms, K1 (2-pass) or K2 (one-view) once a column window, held against
    the in-memory route on the same operand on the card; its time and
    host-to-card rate beside the plain pinned copy rate of this run, its
    bound. Then ``HEAT_TPU_HBM_BYTES`` below the operand: ``materialize``
    (``HEAT_TPU_OOC=0``) refuses it and the staged route runs.
    ``KMeans.partial_fit`` on a ``HostArray`` of a quarter of KMeans' shard
    (K3 once a window, equal to the same windows fed from the card);
    ``pagerank_stream`` on pagerank_2m's edges against ``ht.graph.pagerank``;
    ``OneHotEncoder.stream_transform`` of io_path's codes against its
    ``transform``."""
    import os

    import numpy as np
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.cluster import _cuda_assign as ca
    from heat_tpu_torch.core.linalg import _cuda_sketch as cs
    from heat_tpu_torch.redistribution import staging

    card = CARD_LINE["card"]
    out = {"card": card}
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    a = torch.randn(M, N, device=dev, generator=gen)
    host = staging.HostArray(a.cpu().numpy())
    slab = staging.slab_bytes()
    win_bytes = slab // 2
    copy_rate = _pinned_rate(dev, win_bytes)
    out["pinned_copy_gbps"] = copy_rate / 1e9
    wins = {axis: len(staging.window_extents((M, N), 4, axis, slab)) for axis in (0, 1)}
    A = ht.array(a, split=0)
    for single_pass, kernel in ((False, "sketch_with_norm"), (True, "dual_sketch_with_norm")):
        name = "one_view" if single_pass else "2pass"
        want = ht.linalg.hsvd_rank(A, MAXRANK, compute_sv=True, single_pass=single_pass)
        cs.SKETCH_LAUNCHES = cs.DUAL_LAUNCHES = cs.SKETCH_SM90_LAUNCHES = cs.DUAL_SM90_LAUNCHES = 0
        got = ht.linalg.hsvd_rank(host, MAXRANK, compute_sv=True, single_pass=single_pass)
        torch.cuda.synchronize()
        counts = {"sketch_with_norm": cs.SKETCH_LAUNCHES, "dual_sketch_with_norm": cs.DUAL_LAUNCHES,
                  "sketch_sm90": cs.SKETCH_SM90_LAUNCHES, "dual_sketch_sm90": cs.DUAL_SM90_LAUNCHES}
        U, sigma, V, err = got
        sig_err = float(((sigma.larray - want[1].larray).abs() / want[1].larray).max())
        fac_err = max(_up_to_sign(U.larray, want[0].larray), _up_to_sign(V.larray, want[2].larray))
        err_diff = abs(float(err.larray) - float(want[3].larray))
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            ht.linalg.hsvd_rank(host, MAXRANK, compute_sv=True, single_pass=single_pass)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        streamed = (1 if single_pass else 2) * host.nbytes
        bound_ms = streamed / copy_rate * 1e3
        n_win = wins[1]
        print(f"ooc hsvd_rank(HostArray {M}x{N} float32, {MAXRANK}, single_pass={single_pass}): launches {counts} "
              f"against {n_win} column windows ({wins[0]} row windows, slab {slab} B); against the in-memory route on "
              f"the card: sigma rel {sig_err:.3e} (tol {TOL_OOC['sigma']}), U/V up to sign {fac_err:.3e} "
              f"(tol {TOL_OOC['factors']}), err estimate {err_diff:.3e} (tol {TOL_OOC['err']}); {ms:.1f} ms (host clock, "
              f"median of 3), {streamed / (ms * 1e-3) / 1e9:.2f} GB/s host to card against the plain pinned copy's "
              f"{copy_rate / 1e9:.2f} GB/s (bound {bound_ms:.1f} ms); {card}", flush=True)
        _require(counts[kernel] == n_win and counts["sketch_sm90" if not single_pass else "dual_sketch_sm90"] == n_win
                 and counts["dual_sketch_with_norm" if not single_pass else "sketch_with_norm"] == 0,
                 f"staged hsvd_rank(single_pass={single_pass}) did not launch {kernel} on its Hopper kernel once a window")
        _require(all(t.split is None and t.larray.device == dev for t in got), "staged factors not whole on the card")
        _require(sig_err <= TOL_OOC["sigma"] and fac_err <= TOL_OOC["factors"] and err_diff <= TOL_OOC["err"],
                 f"staged hsvd_rank(single_pass={single_pass}) disagrees with the in-memory route")
        out[name] = {"launches": counts[kernel], "windows": n_win, "sigma_rel": sig_err, "factors": fac_err,
                     "err_diff": err_diff, "ms": ms, "gbps": streamed / (ms * 1e-3) / 1e9, "bound_ms": bound_ms}
    del A, want, got, U, V
    torch.cuda.empty_cache()

    # a card "smaller" than A: materialize refuses, the staged route runs
    saved = {k: os.environ.get(k) for k in ("HEAT_TPU_HBM_BYTES", "HEAT_TPU_OOC")}
    try:
        os.environ["HEAT_TPU_HBM_BYTES"] = str(OOC_HBM_BYTES)
        os.environ["HEAT_TPU_OOC"] = "0"
        try:
            staging.materialize(host, "the north-star operand")
            refused = ""
        except MemoryError as e:
            refused = str(e)
        os.environ["HEAT_TPU_OOC"] = "auto"
        cs.SKETCH_LAUNCHES = 0
        U, sigma, V, err = ht.linalg.hsvd_rank(host, MAXRANK, compute_sv=True)
        torch.cuda.synchronize()
        small_launches = cs.SKETCH_LAUNCHES
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    print(f"ooc with HEAT_TPU_HBM_BYTES={OOC_HBM_BYTES} < A's {host.nbytes} B: materialize refused "
          f"({refused[:120]}...), the staged 2-pass route ran, K1 {small_launches} launches, "
          f"sigma[0] {float(sigma.larray[0]):.4f}; {card}", flush=True)
    _require(bool(refused) and small_launches == wins[1] and bool(torch.isfinite(sigma.larray).all()),
             "staging in a card smaller than the operand")
    out["small_card"] = {"refused": True, "launches": small_launches}
    del host, a, U, V
    torch.cuda.empty_cache()

    # KMeans.partial_fit on a HostArray: K3 once a window
    n = (KM_N // 4) // KM_K * KM_K
    gen.manual_seed(25)
    x = _blobs(gen, n, torch.randn(KM_K, KM_D, device=dev, generator=gen) * 8.0)
    hx = staging.HostArray(x.cpu().numpy())
    kwins = staging.window_extents(hx.shape, 4, 0, slab)
    init = ht.array(x[torch.arange(KM_K, device=dev) * (n // KM_K)])
    km = ht.cluster.KMeans(KM_K, init=init)
    ca.ASSIGN_LAUNCHES = 0
    t0 = time.perf_counter()
    km.partial_fit(hx)
    torch.cuda.synchronize()
    km_ms = (time.perf_counter() - t0) * 1e3
    k3 = ca.ASSIGN_LAUNCHES
    ref = ht.cluster.KMeans(KM_K, init=init)
    for lo, hi in kwins:
        ref.partial_fit(ht.array(x[lo:hi]))
    same = torch.equal(km.cluster_centers_.larray, ref.cluster_centers_.larray)
    print(f"ooc KMeans({KM_K}).partial_fit(HostArray {n}x{KM_D} float32): K3 {k3} launches against {len(kwins)} "
          f"windows, centers bit for bit those of the same windows fed from the card: {same}; {km_ms:.1f} ms "
          f"(host clock), {hx.nbytes / (km_ms * 1e-3) / 1e9:.2f} GB/s; {card}", flush=True)
    _require(k3 == len(kwins) and same, "staged KMeans.partial_fit: K3 once a window, the same centers")
    out["kmeans"] = {"launches": k3, "windows": len(kwins), "ms": km_ms}
    del x, hx, km, ref
    torch.cuda.empty_cache()

    # pagerank_stream on pagerank_2m's edges
    graph = inputs["graph"].tocoo()
    edges = np.repeat(np.stack([graph.row, graph.col], 1).astype(np.int32), graph.data.astype(np.int64), axis=0)
    t0 = time.perf_counter()
    res = ht.graph.pagerank_stream(staging.HostArray(edges), PR_N, tol=PR_TOL)
    pr_ms = (time.perf_counter() - t0) * 1e3
    whole = ht.graph.pagerank(inputs["graph"], tol=PR_TOL, split=None)
    pr_err = float((res.ranks.larray - whole.ranks.larray).abs().max())
    print(f"ooc pagerank_stream({len(edges)} edges of pagerank_2m, {PR_N} nodes): {res.iterations} iterations "
          f"(pagerank: {whole.iterations}), converged {res.converged}, ranks against pagerank's max |Δ| {pr_err:.3e} "
          f"(tol {TOL_RANKS}); {pr_ms:.1f} ms (host clock); {card}", flush=True)
    _require(res.converged and pr_err <= TOL_RANKS, "pagerank_stream disagrees with pagerank")
    out["pagerank_stream"] = {"iterations": res.iterations, "err": pr_err, "ms": pr_ms}

    # OneHotEncoder.stream_transform of io_path's codes
    codes = _onehot_codes(dev)
    enc = ht.preprocessing.OneHotEncoder().fit(ht.array(codes))
    D = enc.transform(ht.array(codes))
    t0 = time.perf_counter()
    dense = enc.stream_transform(staging.HostArray(codes.cpu().numpy().astype(np.int32)))
    oh_ms = (time.perf_counter() - t0) * 1e3
    rows, features, cats = ONEHOT
    idx = D.indices.cpu().numpy().reshape(rows, features)
    ok = dense.shape == (rows, features * cats) and float(dense.sum()) == rows * features and bool(
        (dense[np.arange(rows)[:, None], idx] == 1).all())
    print(f"ooc OneHotEncoder.stream_transform({rows}x{features} codes): dense {dense.shape} float32 on the host, "
          f"its ones where transform's DCSR holds them: {ok}; {oh_ms:.1f} ms (host clock); {card}", flush=True)
    _require(ok, "stream_transform disagrees with transform")
    out["onehot_stream_ms"] = oh_ms
    return out


def _world_io(ht, comm, moved: dict, rank: int, dev) -> dict:
    """I/O across the ranks: load_csv(split=0) of io_path's file, each rank
    reading its byte range, and a rank-ordered save_csv of the same array
    (the file equal to world size 1's); a checkpoint saved at 4 ranks,
    loaded at 4 and on rank 0 at 1, bit for bit; OneHotEncoder on the
    codes split 0, its DCSR equal to world size 1's."""
    import os

    import torch

    ref = WORLD_REFERENCE["io"]
    work = WORLD_DIR["dir"]
    out = {}

    def measured(name, fn):
        comm.counts.clear()
        moved.clear()
        kept = []
        ms = _world_ms(lambda: kept.append(fn()), 1)
        out[name] = {"counts": dict(comm.counts), "bytes": dict(moved), "ms": ms}
        return kept[0]

    a = _io_array(dev)
    A = measured("load_csv", lambda: ht.load_csv(ref["csv"], split=0))
    start, lshape, _ = comm.chunk(a.shape, 0)
    ok = A.lshape == lshape and torch.equal(A.larray.view(torch.int32), a[start : start + lshape[0]].view(torch.int32))
    _every_rank_ok(comm, ok and out["load_csv"]["counts"] == {"all-gather": 2},
                   f"world load_csv split 0: rows or counts differ ({out['load_csv']['counts']})")
    mine = os.path.join(work, "a.csv")
    measured("save_csv", lambda: ht.save_csv(A, mine))
    same = _file_digest(mine) == _file_digest(ref["csv"]) if rank == 0 else True
    _every_rank_ok(comm, same and out["save_csv"]["counts"] == {}, "world save_csv: the file differs from world size 1's")
    gen = torch.Generator(device=dev)
    gen.manual_seed(IO_SEED + 2)
    big = torch.randn(IO_BIG, device=dev, generator=gen)
    b0, bl, _ = comm.chunk(IO_BIG, 0)
    X = ht.array(big[b0 : b0 + bl[0]].clone(), is_split=0)
    del big
    tree = {"a": A, "x": X, "step": 7}
    ck = os.path.join(work, "ckpt")
    measured("save_checkpoint", lambda: ht.utils.save_checkpoint(ck, tree))
    back = measured("load_checkpoint", lambda: ht.utils.load_checkpoint(ck))
    _every_rank_ok(comm, _state_equal(tree, back), "world checkpoint: 4 -> 4 differs")
    del back
    if rank == 0:  # 4 -> 1
        whole = ht.utils.load_checkpoint(ck, comm=ht.MPI_SELF)
        gen.manual_seed(IO_SEED + 2)
        ok1 = (torch.equal(whole["x"].larray, torch.randn(IO_BIG, device=dev, generator=gen))
               and torch.equal(whole["a"].larray, a) and whole["step"] == 7)
        del whole
    else:
        ok1 = True
    _every_rank_ok(comm, ok1, "world checkpoint: 4 -> 1 differs")
    del X, tree
    torch.cuda.empty_cache()
    codes = ht.array(_onehot_codes(dev), split=0)
    enc = ht.preprocessing.OneHotEncoder()
    measured("onehot_fit", lambda: enc.fit(codes))
    D = measured("onehot_transform", lambda: enc.transform(codes))
    indptr, indices = ref["onehot"]
    r0, rows = comm.chunk(codes.shape, 0)[0], codes.lshape[0]
    lo, hi = int(indptr[r0]), int(indptr[r0 + rows])
    ok = (torch.equal(D.lindptr.cpu(), (indptr[r0 : r0 + rows + 1] - lo).to(torch.int32))
          and torch.equal(D.lindices.cpu(), indices[lo:hi]) and bool((D.ldata == 1).all())
          and all(torch.equal(torch.from_numpy(c), r) for c, r in zip(enc.categories_, ref["categories"])))
    ok = ok and D.gnnz == int(indptr[-1])
    _every_rank_ok(comm, ok and out["onehot_transform"]["counts"] == {"all-reduce": 1}  # gnnz, at construction
                   and out["onehot_fit"]["counts"] == {"all-gather": 2},
                   f"world OneHotEncoder: the DCSR differs from world size 1's ({out['onehot_fit']['counts']}, "
                   f"{out['onehot_transform']['counts']})")
    out["onehot_lnnz"] = D.lnnz
    return out


def _report_world_io(per: list, shared: str) -> dict:
    card = CARD_LINE.get("card", "")
    what = {"load_csv": f"ht.load_csv({IO_ROWS}x{IO_COLS} float32, split=0), each rank its byte range",
            "save_csv": "ht.save_csv of the split-0 array, ranks in turn (the file equal to world size 1's)",
            "save_checkpoint": f"save_checkpoint of the CSV array and {IO_BIG[0]}x{IO_BIG[1]} float32 split 0",
            "load_checkpoint": "load_checkpoint at 4 ranks (and on rank 0 at 1), bit for bit",
            "onehot_fit": f"OneHotEncoder.fit of {ONEHOT[0]}x{ONEHOT[1]} codes split 0",
            "onehot_transform": "OneHotEncoder.transform: each rank its rows' DCSR slab, equal to world size 1's"}
    for name, label in what.items():
        each = [p[name] for p in per]
        print(f"world io {name}: {label}: {each[0]['ms']:.1f} ms (rank 0, CUDA events around the call; ranks "
              f"{[round(e['ms'], 1) for e in each]}); collectives a rank {each[0]['counts']}, bytes a rank put in "
              f"{[e['bytes'] for e in each]}; {shared}; {card}", flush=True)
    return {name: [p[name]["ms"] for p in per] for name in what}


def profile_breakdown(label: str, call) -> list:
    """Device time by kernel for one ``call()``, from torch.profiler
    (device-side events only; the wall time includes the profiler's own
    cost); returns the names of the device work that ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(
        (e.self_device_time_total / 1e3, e.count, e.key)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
    )[::-1]
    busy_ms = sum(r[0] for r in rows)
    top = "; ".join(f"{key[:100]} x{count} {t:.3f} ms" for t, count, key in rows[:8] if t > 0)
    print(
        f"profile {label}: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}); by kernel: {top}", flush=True,
    )
    PROFILES[label] = (wall_ms, busy_ms)
    return [key for _, _, key in rows]


def main() -> int:
    import os
    import pickle
    import shutil
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_report()
    CARD_LINE["card"] = card
    build_kernels()
    errs = check_kernels(dev)
    assign_err = check_assign(dev)
    sort_errs = check_sort(dev)
    inputs = sparse_inputs()
    spmm_errs = check_spmm(dev, inputs)
    att_errs = check_attention(dev)
    relayout_errs = check_relayout(dev)
    random_errs = check_random(dev)
    launches = main_path(dev)
    assign_launches = kmeans_path(dev)
    sort_launches = sort_path(dev)
    sparse_launches = sparse_path(dev, inputs)
    att_launches, att_launches_sm90, att_path_errs = attention_path(dev)
    relayout_launches = relayout_path(dev)
    surface = surface_path(dev)
    indexing = indexing_path(dev)
    train = train_path(dev)
    kmd = kmedians_path(dev)
    manip = manip_path(dev)
    linalg = linalg_path(dev)
    est = estimators_path(dev, inputs)
    io = io_path(dev)
    ooc = ooc_path(dev, inputs)
    wire = wire_path(dev)
    world_sparse_reference(dev, inputs)
    shared = tempfile.mkdtemp(prefix="heat_sparse_")
    WORLD_REFERENCE["sparse"]["inputs"] = os.path.join(shared, "inputs.pkl")
    with open(WORLD_REFERENCE["sparse"]["inputs"], "wb") as f:
        pickle.dump({"bsr": inputs["bsr"], "graph": inputs["graph"]}, f)
    launches["world"] = world_path(dev)
    shutil.rmtree(shared, ignore_errors=True)
    shutil.rmtree(io["dir"], ignore_errors=True)
    rows = timings(dev, launches, errs)
    rows.append(kmeans_timings(dev, assign_launches, assign_err))
    rows[-1]["world_launches"] = {"kmeans_fit": launches["world"]["kmeans"]}
    rows[-1]["estimator_launches"] = {"spectral_fit": est["launches"]["Spectral_k3"]}
    rows.extend(sort_timings(dev, sort_launches, sort_errs))
    k4_row = next(row for row in rows if row["name"] == "pair_sort_one_segment")
    k4_row["world_launches"] = {**launches["world"]["sort"], **launches["world"]["surface"]}
    k4_row["surface_launches"] = surface["launches"]
    k4_row["indexing_launches"] = indexing["launches"]
    k4_row["kmedians_launches"] = {est: kmd[est]["k4"] for est in ("KMedians", "KMedoids")}
    k4_row["kmedians_launches"]["world"] = launches["world"]["kmedians"]
    k4_row["train_shuffle_launches"] = train["shuffle"]["k4"]
    k4_row["estimator_launches"] = {"robust_scaler_fit": est["launches"]["RobustScaler_k4"],
                                    "world_robust_scaler_fit_split0": launches["world"]["estimators"]["RobustScaler_0"]["k4"],
                                    "world_robust_scaler_fit_split1": launches["world"]["estimators"]["RobustScaler_1"]["k4"]}
    rows.extend(sparse_timings(dev, inputs, sparse_launches, spmm_errs))
    rows.extend(launches["world"]["sparse_rows"])
    next(row for row in rows if row["name"] == "brick_spmm_pagerank")["estimator_launches"] = {
        "spectral_embedding": est["launches"]["embedding_k7"]}
    att_rows = attention_timings(dev, att_launches, att_launches_sm90, att_errs, att_path_errs)
    for row in att_rows:  # K9's launches a rank in the world's ring at the row's shape
        key = row["name"].removeprefix("flash_attention_")
        world = {n: v for n, v in launches["world"]["attention"].items() if n.removesuffix("_4097") == key}
        if world:
            row["world_launches"] = world
        backward = {n: v for n, v in launches["world"].get("attention_backward", {}).items()
                    if n.removesuffix("_4097") == key}
        if backward:
            row["world_backward"] = backward
    rows.extend(att_rows)
    relayout_rows = relayout_timings(dev, relayout_launches, relayout_errs)
    for row, key in zip(relayout_rows, ("k5", "k6")):  # none on one rank: no resplit under the manipulations
        row["manip_launches"] = manip["launches"][key]
    rows.extend(relayout_rows)
    rows[0]["manip_launches"] = {"gallery_hsvd": manip["launches"]["k1"]["sketch_with_norm"]}
    rows[0]["ooc_launches"] = {"hsvd_2pass": ooc["2pass"]["launches"], "small_card": ooc["small_card"]["launches"]}
    rows[1]["ooc_launches"] = {"hsvd_one_view": ooc["one_view"]["launches"]}
    next(row for row in rows if row["name"] == "fused_assign")["ooc_launches"] = {"partial_fit": ooc["kmeans"]["launches"]}
    r1_rows = random_timings(dev, random_errs)
    r1_rows[0]["world_launches"] = launches["world"]["random"]
    split1_row = next(row for row in r1_rows if row["name"] == "r1_normal_north_star_split1")
    split1_row["world_launches"] = launches["world"]["random_split1"]
    split1_row["launches"] = launches["world"]["random_split1"][1]  # rank 1 draws the row's chunk
    r1_rows[0]["train_launches"] = {"cnn_per_step": train["cnn"]["r1_per_step"],
                                    "mlp_per_step": train["mlp"]["r1_per_step"], "shuffle": train["shuffle"]["r1"],
                                    "kmedians_seeding": R1_PATH["kmedians_fit"]["launches"]}
    r1_rows[0]["manip_launches"] = manip["launches"]["r1"]
    r1_rows[0]["linalg_launches"] = {"lanczos_start_vector": linalg["r1"]["lanczos"]["launches"],
                                     "world_eigh_probes": launches["world"]["linalg"]["eigh_r1"]}
    r1_rows[0]["estimator_launches"] = {"scalers_draw": R1_PATH["estimators_draw"]["launches"],
                                        "spectral_fit": est["launches"]["Spectral_r1"]}
    rows.extend(r1_rows)
    rows.extend(quant_timings(dev, wire, launches["world"]["wire"], errs))
    print(f"R1 on the main paths: {R1_PATH}", flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"surface": surface["rows"]}))
    print(json.dumps({"indexing": indexing["rows"]}))
    print(json.dumps({"training": {k: v for k, v in train.items()}, "kmedians": kmd}))
    print(json.dumps({"manipulations": manip["rows"], "launches": manip["launches"],
                      "world": launches["world"]["manip"]}))
    print(json.dumps({"linalg": linalg["rows"], "world": launches["world"]["linalg"]}))
    print(json.dumps({"estimators": est["rows"], "launches": est["launches"], "world": launches["world"]["estimators"]}))
    print(json.dumps({"io": {k: v for k, v in io.items() if k != "dir"}, "world": launches["world"]["io"]}))
    print(json.dumps({"ooc": ooc}))
    print(json.dumps({"wire": wire, "world": launches["world"]["wire"]}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
