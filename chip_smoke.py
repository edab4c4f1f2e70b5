#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to their
plain versions.

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is caught and passed over):
  1. device: require CUDA; print the card's name, count, PIL's version
     and its libtiff's (where the machine has PIL), and the
     `nvidia-smi --query-gpu=name,power.limit` line.
  2. build: compile every kernel under gaussian_splatting_torch/csrc with
     nvcc (one process per source, all at once) and print ptxas's
     register / shared-memory / spill report; beside them the host sources
     (csrc/jpeg_decode.cc, the JPEG decoder, JPEG-in-TIFF strips
     included, csrc/webp_decode.cc, the WebP decoder, and
     csrc/image_codecs.cc, TIFF's LZW (both styles), PackBits and
     ThunderScan, BMP's RLE, GIF's LZW, TGA's RLE, QOI's ops, PCX's and
     SGI's RLE, PSD's PackBits, FLI's and icns's runs, Sun raster's RLE,
     MSP's runs, XBM's hex text, PhotoCD's YCC rows and IM's bit-packed
     floats, csrc/fax_decode.cc,
     TIFF's CCITT fax, and csrc/zstd_decode.cc, ZSTD-in-TIFF's Zstandard
     frames; host C++, `c++`), with their build time.
  3. kernels vs plain: preprocess and bin a scene once, feed the same sorted
     lists to each CUDA kernel and to its plain torch version. Random scenes
     at 128x128 and 333x197 for the three compiled tile geometries (32x32,
     32x16, 16x16) and five runtime ones (8x8, 16x8, 8x16, 24x20, 64x64:
     fewer pixels than 256 threads, non-square, 480 pixels, the largest);
     at each of these geometries, 160 thin splats (near-singular conics,
     tests/test_torch_gpu.py's) in every tile of 75x53 through the forward
     only; and the
     trained model (assets/trained_r5.ply) at 1920x1080 (3 camera angles for
     the forward, angle 0 for the backward).
     Forward tolerance: >= 99.9% of pixels within 1e-5 and every pixel
     within 1e-2 on the image and on final_t (the kernels round three
     steps as FMAs, csrc/blend.cuh, which the plain version rounds alike
     on the card, through float64; where a tie rounds otherwise, an alpha
     >= 1/255 or T >= 1e-4 decision can flip). The golden scene of tests/test_golden_render.py,
     rendered through `rasterize`, is held to its fixture with the same rule
     at 2e-5.
     Backward and routing, with seeded random cotangents, per gradient
     field: relative L2 error <= 1e-4, and >= 99.9% of rows (entries for the
     backward, Gaussians for the routing) within 1e-3 x the field's max
     |grad|. The backward's replayed final T must equal the forward's
     final_t bit for bit, and two runs of the backward, and of the routing,
     must give the same bits. On every forward input the forward must give
     the bits of its form with the box cull off (`reach` boxes infinite):
     the cull may leave out only pairs the blend skips.
     The transpose (`relayout_to_rows`) at (9, K) and (16, K) for K =
     1,900,544 (the profiler's capacity) and an odd K = 1,339,001 must be
     bit-equal to its plain version: it is a copy. The column sums
     (`consume_rows`, `consume_t`) on seeded (K, 16) tables: per column
     |result - float64 sum| <= 1e-5 x sum |x| for the kernel and for the
     plain version (float32 partials summed in another order), and two runs
     of each kernel give the same bits.
  4. render path: the trained model through the user entry points
     (params_from_ply -> eval_render) at 1920x1080 with 32x32 tiles; 50
     frames after a warm-up; the forward kernel's launch counter must rise
     by exactly 50. Prints the entry count, frame latency (median, p80),
     peak device memory, each stage's stream time (CUDA events), the device
     busy share and top kernels (torch.profiler), the kernel's time (CUDA
     events) beside its bound, and the plain version's time; the (entry,
     32-pixel unit) pairs it evaluates, registers per thread, threads per
     block and resident blocks per SM.
  5. train path: params_from_ply -> init_train_state -> 20 train_steps of
     the trained model at 1920x1080 (camera angle 0, 32x32 tiles, black
     background, SH degree 3, OptimizationConfig() defaults) toward the
     model's own render from angle 0.2 rad. Every step's entry count must
     fit the capacity, every loss be finite, the loss after step 20 be below
     step 1's, and each of the three kernels be launched exactly 20 times.
     Prints step latency (median, p80 of the last 15), peak device memory,
     each stage's stream time, the device busy share and top kernels, and
     the backward and routing kernels' times beside their bounds, their
     plain versions' times and, for routing, `index_add_`'s time and the
     run lengths (max and p99.9 of the entries per Gaussian); the
     backward's (entry, warp band) reductions (pairs of an entry and a warp
     in which some pixel blended it), its (entry, unit) pairs, registers
     per thread and resident blocks per SM.
  5b. trainer path: `Trainer` from a point cloud, at full width: the
     122,535 points of assets/trained_r5.ply with colours from its DC
     coefficients, written and read back through the point-cloud PLY
     functions; 8 orbit cameras at 1920x1080 (fov 70 degrees) whose targets
     are the trained model's renders; `init_from_pcd` (the Morton KNN on
     the card), then 300 steps at `OptimizationConfig()` defaults but the
     cadence (densify every 5 steps from 10 to 295, opacity reset at 200), 32x32
     tiles, auto capacity, seed 0. Fails unless every loss is finite, the
     mean of the last 20 losses is below the first 20's, a densify took the
     device path and one the host path with a capacity growth, every live
     opacity is <= 0.01 after the reset, every step's entry count fit the
     capacity it ran at or the capacity grew right after it, the three
     kernels' counters rose by exactly the step count, a checkpoint
     reloaded into a fresh `Trainer` and saved again holds bit-equal live
     rows, moments, step and statistics and the trainer steps on, the live rows saved as a PLY
     model and reloaded render within the forward's rule of the trainer's
     own render. The three train-path kernels are held to their plain
     versions, by phase 3's rules, at two of the trainer's states: the one
     just after the opacity reset (every opacity <= 0.01, so T never
     saturates and nearly every pair blends) and the final one, after the
     device densifies that followed the reset's compaction, each at
     its own preprocess and binning (live rows, SH degree, entry capacity)
     from a trainer camera. Prints the step latency (median, p80) over the
     steps after the first epoch that run no maintenance beside phase 5's,
     each densify (path, counts, live rows, rows, ms), reset, probe,
     `create_from_pcd` and checkpoint times, the KNN's times (Morton at
     122,535 points, exact at 20,000), first and last loss and PSNR, the
     final live count and peak device memory.
  5c. CLI path: the user's entry path, in process on the card at full
     width. A COLMAP dataset in a temporary directory, written with the
     port's writers: one PINHOLE camera (1920x1080, fov 70 degrees), 16
     orbit views around trained_r5 (world-to-camera quaternion and
     translation), its 122,535 centres coloured clip(0.5 + C0 f_dc) * 255
     as uint8, and each view's `eval_render` of trained_r5 quantised
     clip * 255 + 0.5: the 14 train views as baseline JPEG (4:2:0, q95,
     this script's encoder: a float DCT, the Annex K tables scaled by
     quality, the standard Huffman tables; view_01 with a restart marker
     every MCU row and one flipped bit of entropy-coded data, view_02
     with extraneous bytes before its DQT and SOS markers, both of which
     libjpeg only warns about), but view_03 as a 16-bit RGB TIFF (LZW with
     Predictor 2, the render in each sample's high byte), view_04 as a
     24-bit BMP, view_05 as a lossless WebP (this script's VP8L writer:
     literal prefix codes, no transforms), view_06 as a binary P6, view_07
     as a 32-bit RLE TGA (alpha 255), view_09 as an RGB JPEG-in-TIFF
     (q95, strips of 16 rows, its tables in the JPEGTables tag), view_10
     as a YCbCr JPEG-in-TIFF (4:2:0 q95, strips of 16, GDAL's
     PHOTOMETRIC=YCBCR), view_11 as a BigTIFF of LZMA planes (strips of
     64 rows) and view_12 as a 1920x1080 JPEG 2000 (the PIL-written
     tests/fixtures/torch_jp2/ortho_97_rpcl_1920x1080.jp2: 9/7, 512x512
     tiles, RPCL, 3 layers, precincts; its own picture, not the view's
     render, which must read as PIL's committed SHA-256) and view_13 as a
     1920x1080 HTJ2K codestream (tests/fixtures/torch_htj2k/
     ortho_ht_1920x1080.j2k, the test-side encoder's: RPCL, 64x64 HT
     code-blocks, cleanup passes; its own picture, PIL's committed
     SHA-256) and view_14 as a 1920x1080 JPEG 2000 Part 2 codestream of
     20-bit RGB samples (tests/fixtures/torch_jp2_part2/
     ortho_part2_1920x1080.j2k: 9/7 with the ICT, Rsiz bit 15, a CBD, an
     MCT offset array through an MCC and an MCO; its own picture, PIL's
     committed SHA-256) and view_15 as a YCbCr TIFF without JPEG (LZW
     strips of 4:2:0 data units from this script's writer, the chroma the
     mean of each unit), named so in images.bin, the 2 test views as PNG.
     The port's readers must give back every camera (R, T within 1e-12),
     every PNG, TIFF, BMP, WebP, PPM and TGA pixel, view_15 bit-equal to
     libtiff's YCbCr -> RGB of the units written (this script's own copy
     of TIFFYCbCrToRGBInit's tables) and within 30 dB PSNR of its render,
     and each JPEG and JPEG-in-TIFF view within 30 dB PSNR of its render; the two damaged views decoded by the compiled decoder (the
     one the train CLI's Scene runs) bit-equal to the plain one, their
     PSNR printed; and a
     copy of the first
     view's pixels as a PNG whose rows cycle through all five row filters
     (the Average and Paeth rows of PIL- or libpng-written datasets take
     the reader's anti-diagonal path) must decode bit-equal. The compiled
     JPEG decoder must equal the plain one (utils/jpeg.py) bit for bit on
     view_01 and on every file of tests/fixtures/torch_jpeg, and PIL's
     pixels committed beside each. One view's pixels at 1920x1080 in
     each form beyond PNG and 3-component JPEG (TIFF raw 8- and 16-bit,
     PackBits, LZW + Predictor 2 at 16 bits, deflate + Predictor 2; BMP
     24-bit and RLE8; CMYK and YCCK JPEG; WebP VP8L; an interlaced GIF of
     palette indices; P6 at 8 and 16 bits, P5 at 16 bits, plain P3, Pf;
     TGA raw 24-bit, RLE 32-bit and colour-mapped RLE; JPEG-in-TIFF in
     strips and in 256x256 tiles, and in YCbCr 4:2:0; a planar LZMA
     BigTIFF, 16-bit planar deflate with Predictor 2, a BigTIFF of deflate
     strips; all from this script's writers) through
     `image_io.open_image`, each timed (median of 3): the lossless ones
     bit-equal to what was written (the GIF and the colour-mapped TGA
     their indices, the 16-bit P6 PIL's rounding of its samples), the JPEGs
     mode CMYK within 30 dB PSNR and `to_rgba` PIL's cmyk2rgb of what they
     give, the JPEG-in-TIFFs bit-equal to their strips or tiles read alone
     by the regular decoder and within 30 dB PSNR; the three 1920x1080 WebP
     files of tests/fixtures/torch_webp (lossy q90, lossy with alpha,
     lossless), the PIL-written 1920x1080 JPEG-in-TIFF of
     tests/fixtures/torch_tiff_jpeg, the PIL-written ZSTD and LZMA (with
     Predictor 2) files of tests/fixtures/torch_tiff_forms, the four
     GIS forms `form_files` writes from an integer-made picture (YCbCr
     JPEG-in-TIFF, whose bytes must be the committed file's too, planar
     LZMA BigTIFF, 16-bit planar deflate, BigTIFF deflate) and the three
     large JPEG 2000 files of tests/fixtures/torch_jp2 (the 1920x1080 9/7
     tiled RPCL JP2, the 1920x1080 5/3 lossless codestream, the 800x800
     RGBA 9/7 frame) and the 1920x1080 Part 1 codestream of
     tests/fixtures/torch_jp2_part1 (all six code-block styles, SOP, EPH,
     a two-entry POC, RCT, 2 layers, lossy by truncation: the form
     `opj_compress -SOP -EPH -M 63 -POC` writes) and the 1920x1080 HTJ2K
     codestream and the 1920x1080 Part 2 codestream of 20-bit samples the
     mode, shape and SHA-256 of PIL's pixels committed beside them
     (sha256.json), and where this machine has PIL, PIL's own decode of
     those six timed beside the port's (a comparison only);
     every small file of tests/fixtures/torch_jp2
     (each option of PIL's JPEG 2000 writer, box-edited JP2s) and of
     tests/fixtures/torch_jp2_part1 (SOP / EPH, PPM, PPT, POC in the main
     and a tile-part header, each code-block style and all six, RGN, 4:2:0
     and 4:2:2 sYCC, subsampled alpha, an unknown marker, a JPX file with
     two codestreams) and of tests/fixtures/torch_htj2k (HT cleanup,
     SigProp and MagRef passes, 5/3 and 9/7, grey, I;16, RGBA, tiles with
     precincts, RPCL and a POC, two layers, 4:2:0 sYCC, CAP / CPF edits,
     the 800x800 RGBA HT frame) and of tests/fixtures/torch_jp2_part2
     (Rsiz bit 15, MCO, MCT / MCC / MCO offset arrays in either header, a
     CBD, NLT / ATK / 0xFF7A-0xFF7D skipped, 17- to 31-bit samples signed
     and unsigned, 5/3 and 9/7, MQ and HT, the 800x800 RGBA Part 2 frame)
     PIL's mode, pixel and RGBA SHA-256, or a raise naming the file where
     PIL raises (MIXED code-blocks, a CAP in a tile-part header, a CBD or
     MCO of a wrong length, SGcod MCT 2, five components); and every file of
     tests/fixtures/torch_images (BMP, TIFF, CMYK and YCCK JPEG, WebP lossy,
     with alpha, lossless and animated, GIF), torch_ppm_tga (PPM, PGM, PBM,
     PFM, TGA) and torch_tiff_jpeg (small JPEG-in-TIFFs, strips and tiles)
     must give PIL's mode, pixels and RGBA committed beside it. The TIFF
     forms of fax archives, old JPEG-in-TIFF writers, YCbCr scanners,
     float and CIELab pipelines at 1920x1080 (the PIL-written Group 4 and
     Group 3 2-D files of tests/fixtures/torch_tiff_rest, and the forms
     `rest_form_files` writes: old-style JPEG with its tables in tags,
     YCbCr deflate 4:2:0, float32 deflate with Predictor 3, CIELab LZW,
     ThunderScan), each decoded three times and, where this machine has
     PIL, by PIL three times (medians printed side by side), must give the
     mode, shape and SHA-256 of PIL's pixels committed in its sha256.json,
     and its small files (fax, CIELab, float, palette + alpha, old-style
     JPEG, ThunderScan, YCbCr) PIL's mode, pixels and RGBA. Then
     `cli.train.main`
     (-r 1 --eval, 200 iterations, a report at 200, a PLY at 100 and
     200, a checkpoint at 200, a densify every 20 steps from 40 to 140, the
     opacity reset at 120; 14 train and 2 test views): the files must
     exist, the run reach 200, a densify run, the mean of the last 20
     losses be below the first 20's, and the PLY at 200, reloaded, render
     the bits of the trainer's final state. At that state (its padded
     rows, the dead rows the reset and the prunes left, its entry
     capacity) and the first test camera, the forward, the backward and
     the routing are held to their plain versions by phase 3's rules
     (`check_state`; these launches are not the path's).
     `cli.render.main(["-m", M])`:
     14 + 2 renders and ground truths, each ground truth bit-equal to the
     dataset's image (`image_io.read_image`: JPEG or PNG), the first test render bit-equal to `eval_render` of the
     reloaded PLY quantised the same way. Before it, LPIPS: a seeded
     random-weight .npz of all three backbones (the shapes of the weight
     generators in tests/test_lpips.py) named by GS_TPU_LPIPS_WEIGHTS; each
     backbone's LPIPS of two 1080p renders of trained_r5 (angles 0 and 0.2)
     in float32 within rel 1e-4 of float64, and its ms per pair.
     `cli.metrics.main(["-m", M])`: `ours_200` with a finite SSIM, PSNR and
     LPIPS, the PSNR within 1e-4 dB of a float64 one from the PNGs, the
     LPIPS within rel 1e-4 of `lpips` on the PNG pairs. The compositing kernels'
     counters must equal the schedule: per train-CLI step one launch of
     each, per report one forward for each of the 2 test views and 5 train
     views; one forward per render-CLI view. Prints the PNG encode and
     decode ms at 1080p (the decode of the port's Sub-filtered files and
     of the five-filter file), the JPEG decode ms (compiled at 1080p,
     plain on view_01, both on the 1237x822 fixtures), the TIFF, BMP and
     WebP views' and each 1080p form's decode ms, one 1920 -> 1600
     resize, the train CLI's wall time, its scene load and step median (from the `iter_time_ms` it records in
     each history entry), the time of tensorboard's image panels where
     tensorboard imports and which optional packages import, the render
     CLI's ms per view, the metrics CLI's ms, the phase's peak device
     memory and wall time. `sys.stdout`, which each CLI's `safe_state`
     replaces, is restored after each.
  5e. Blender path: the NeRF-synthetic user's entry, in process on the
     card at NeRF-synthetic's width. A dataset in nerf_synthetic/lego's
     layout (transforms_train.json, transforms_test.json, train/r_<i>.png,
     test/r_<i>.png, camera_angle_x 0.6911112070083618): 16 train and 4
     test frames at 800x800, renders of trained_r5 from an orbit at lego's
     camera distance 4.0311 (the scene scaled so trained_r5's
     95th-percentile radius is 1), alpha 1 - the forward's final T, the
     colour straight (C / alpha where alpha >= 1/255, else 0). Train
     frames 1, 3, 5, 7, 9 are written by this script's own PNG writer as
     16-bit RGBA, palette + tRNS, Adam7 RGBA, 8-bit grey + alpha and 8-bit
     RGB with a tRNS colour, frame 2 as a 32-bit RLE TGA with its alpha,
     frame 6 as a 16-bit RGBA TIFF in deflate planes (Predictor 2),
     frame 4 as a 16-bit P6 (the straight colour, no alpha), frame 11 as a
     CMYK JPEG (Adobe transform 0, the frame composited on white), frame 8
     as an RGBA JPEG 2000 (the PIL-written 800x800 9/7 frame of
     tests/fixtures/torch_jp2, whose RGBA must give PIL's committed
     SHA-256), frame 10 as an RGBA HTJ2K JP2 (the 800x800 HT frame of
     tests/fixtures/torch_htj2k, held the same way), frame 12 as an RGBA
     JPEG 2000 Part 2 JP2 (the 800x800 frame of
     tests/fixtures/torch_jp2_part2: Rsiz bit 15, a CBD, an MCT / MCC /
     MCO in its tile-part header; held the same way), frame 13
     as a 32-bit BI_BITFIELDS BMP with an alpha mask, frame 14 as a
     palette + alpha TIFF (PIL's mode PA: 6 levels a channel in a
     256-entry ColorMap, the alpha its own sample, deflate) and frame 15 as an
     interlaced palette GIF (4 levels a channel, alpha below 128 the
     transparency index), each file named r_<i>.png as the transforms
     file lists it; the others 8-bit RGBA. Every lossless frame's
     `image_io.open_image` + `to_rgba` must equal, bit for bit, the RGBA
     this script derives by PIL's rules (high bytes, palette colours and
     tRNS alphas, grey spread, alpha 0 on the tRNS colour, a BMP's BGRA
     under its masks, a GIF's palette colours, alpha 0 on its transparency
     index, a TGA's BGRA, a 16-bit P6's rounding to 8 bits, opaque, the
     planar TIFF's high bytes, the PA TIFF's palette colours and alpha); the
     CMYK JPEG must read as mode CMYK within 30 dB
     PSNR of the CMYK written, and its `to_rgba` be PIL's cmyk2rgb of
     those pixels; the ms per form is printed. Then `cli.train.main`
     (-s -m --white_background --eval, 300 iterations, reports at 150 and 300, a PLY at 300, a
     densify every 30 steps from 30 to 240, the reset at 180) from the
     default 100,000 random points (np.random seeded by the script): the
     run reaches 300 with finite losses whose last 20 average below the
     first 20, the init cloud holds 100,000 points in [-1.3, 1.3]^3, the
     background is white, and the compositing kernels' counters equal
     the schedule (one launch of each per step, one forward per report
     view: the 4 test and 5 train views). At the run's final state (grown
     from the random cloud, then pruned; its capacity), the first test
     camera at 800x800 and the white background, the forward, the
     backward and the routing are held to their plain versions by phase
     3's rules (`check_state`; these launches are not the path's, and
     their errors join the kernels line's max_abs_err). `cli.render.main` on both
     splits: one forward per view, every render and ground-truth PNG
     written, and in every render the darkest 8x8 corner averages >= 0.8
     of white; `cli.metrics.main`: a finite SSIM, PSNR and LPIPS (the
     seeded random LPIPS weights of 5c). Prints the scene load, the
     Morton KNN's ms at 100,000 points, the train CLI's wall and step
     median, the render CLI's ms per view, the metrics, the phase's peak
     device memory and wall time.
  5g. the user's commands, in process on the card: the train CLI as a
     user starts it (no -r, the viewer on), a resume, the render and
     metrics CLIs. A COLMAP dataset frozen from PR to PR: 12 views of
     trained_r5 on phase 5c's orbit at 1957x1091 (Tanks and Temples'
     truck views in the 3DGS authors' tandt_db release), each a baseline
     4:2:0 JPEG at q95 (encode_jpeg); no other image form enters it.
     Run A: `cli.train.main` with -s -m --eval --port <free port>, 120
     iterations, reports and PLYs at 60 and 120, a checkpoint at 60,
     --random_background, --profile_iteration 30, a densify every 20 steps
     from 40 to 80 and the reset at 80 (5c's window scaled). Every camera
     must be 1600x891 (the default -r -1 scales views wider than 1600 px)
     and cameras.json list the dataset's 1957x1091, as the JAX CLI and the
     reference write it; one view's ground truth bit-equal to
     `image_io.resize` of its decoded JPEG; the compositing counters the
     schedule (one launch of each per step, one forward per report view
     and per served frame); the loss finite, the 20 steps before the reset
     below the first 20, a densify run; <A>/profile/trace_30.json naming
     the three kernels' symbols. Meanwhile a loopback client (this
     script's copy of the reference viewer's wire protocol) sends a
     request with `train` (served, then training goes on), then at a
     train view's pose the 1600x891 frame twice (equal, not black), a
     1920x1080 frame at scaling modifier 1 and 0.5 (0.5 lights fewer
     pixels) and with both SIBR toggles (within one uint8 level of the
     plain one), a request with `train`, closes, and a second client sends
     half a request and closes; the run must finish its 120 iterations,
     and each frame's ms and the 1080p frame's entry count against the
     trainer's capacity are printed. At run A's final state, a test view
     at 1600x891 and the trainer's capacity, the forward, the backward and
     the routing are held to their plain versions by phase 3's rules
     (`check_state`; not counted). The trainer the CLI returns, served by
     a fresh bridge on an ephemeral port: each of the four frames within
     one uint8 level of `eval_render` on the same camera. Run B: -s -m
     --start_checkpoint <A>/chkpnt60.pth --iterations 120 --debug_from 110
     --detect_anomaly --disable_viewer: its iterations 61 to 120, the state
     right after the load bit-equal on the card to the checkpoint's live
     rows, Adam moments, step and statistics, the entry capacity probed at
     step 61 and no step over its capacity, no anomaly raised and anomaly
     detection off again after the CLI returns, the final PLY finite.
     `cli.render` -m A --iteration 60 --skip_train and -m B --skip_test:
     one forward a view, every PNG 1600x891, A's test view 0 within one
     uint8 level of `eval_render` of point_cloud/iteration_60;
     `cli.metrics` -m A as in 5c. Prints the dataset's build, the scene
     loads, the JPEG decode and resize ms of one view, both runs' wall and
     step median, the viewer's frames, the device busy share of a 1600x891
     trainer step, the render CLI's ms per view, the metrics, the phase's
     peak device memory and wall time.
  5h. the legacy forms, after 5g: (a) one seeded file of each form,
     written by tests/torch_image_writers.py (the tests' writers, standard
     library and numpy only) from the form picture at
     1920x1080: a 24-bit DIB, an RGBA QOI, an RGB PCX, RLE SGI at 8 and
     at 16 bits, an RLE PSD, a DCX; and two 256x256 ICOs, one of a PNG
     entry and one of a 32-bit BMP entry. Each file must be the bytes PIL
     read and `image_io.open_image` must give PIL 12.1.0's mode, shape and
     pixels' SHA-256 (tests/fixtures/torch_legacy_forms/sha256.json,
     written by its make_fixtures.py). Prints the port's median of 5
     decodes (host clock) and, where this machine has PIL, PIL's median
     of 3. (b) A COLMAP dataset of 7 views of trained_r5 on phase 5c's
     orbit at 1920x1080, one view in each of the seven 1080p forms (QOI's
     alpha 255), each read back as its render; `cli.train` -r 1 for 30
     iterations (--disable_viewer): every camera 1920x1080, finite losses,
     one launch of each compositing kernel a step; at its final state and
     a train view the forward, the backward and the routing held to their
     plain versions by phase 3's rules (`check_state`; not counted).
     Prints the dataset's build, the scene load, the wall and step median,
     the phase's peak device memory and wall time.
  5i. DDS, after 5h: (a) one 1080p file of each of 18 DDS forms, written
     by tests/torch_image_writers.py from the form picture
     (`dds_form_files`: A8R8G8B8, X8R8G8B8, R8G8B8, R5G6B5, L8, LA16, P8,
     DXT1, DXT3, DXT5, BC4, BC5, BC5S, DX10 BC1, BC6H UF16 and SF16, BC7,
     DX10 R8G8B8A8). Each file must be the bytes PIL read and
     `image_io.open_image` must give PIL 12.1.0's mode, shape and pixels'
     SHA-256 (tests/fixtures/torch_dds/sha256.json, written by its
     make_fixtures.py). Prints the port's median of 5 decodes (host
     clock) and, where this machine has PIL, PIL's median of 3 (of 1 for
     A8R8G8B8 and none for the other mask forms, which PIL decodes in
     Python at ~10 s a file). (b) A COLMAP dataset of 7 views of
     trained_r5 on phase 5c's orbit at 1920x1080, one each DXT1, DXT5,
     DX10 BC1, BC7, BC6H UF16, A8R8G8B8 and DX10 R8G8B8A8 (alpha 255):
     the block-coded views must read back as their writer's own decoding
     of its blocks (which tests/test_torch_dds.py holds bit-equal to PIL;
     the views are renders made here, so no PIL hash of them can be
     committed), the others as their renders; `cli.train` -r 1 for 30
     iterations as in 5h, its checks and prints.
  5j. AVIF, after 5i: (a) the seven committed 1080p files of
     tests/fixtures/torch_avif (PIL 12.1.0 wrote them: 4:2:0 q75 at its
     default speed, 4:4:4 q90, 4:0:0, RGBA, limited range, 2x2 tiles,
     4:2:0 q50 at speed 10). Each must be the file PIL read (its SHA-256)
     and `image_io.open_image` must give PIL's mode, shape and pixels'
     SHA-256 (sha256.json, written by its make_fixtures.py). Prints the
     port's median of 5 decodes (host clock) beside this machine's PIL's
     median of 3 with its libavif and codec versions, or "no AVIF in this
     PIL", and one decode split into the container, the AV1 symbols with
     reconstruction, the deblocking and YUV -> RGB. (b) A COLMAP dataset
     of 7 views of trained_r5 on phase 5c's orbit at 1920x1080: where this
     machine's PIL writes AVIF, the renders encoded by it with the seven
     views' options (RGBA with alpha 255; CDEF and loop restoration off,
     `AVIF_ADVANCED`), each held to that PIL's decode; else the seven
     fixtures, held to their committed hashes; the phase prints which.
     `cli.train` -r 1 for 30 iterations as in 5h, its checks and prints.
  5k. AVIF with AV1's CDEF and loop restoration, after 5j: (a) the three
     committed 1080p files of tests/fixtures/torch_avif that use them
     (PIL 12.1.0 wrote them: 4:2:0 q50 at speed 2 and 4:4:4 q60 at speed
     4 with CDEF on, 4:2:0 q50 at speed 0), held and timed as in 5j (a),
     with the tools each used and one decode split into the container,
     the AV1 symbols with reconstruction, the deblocking, CDEF, loop
     restoration and YUV -> RGB. (b) A COLMAP dataset of 7 views of
     trained_r5 on phase 5c's orbit at 1920x1080: where this machine's
     PIL writes AVIF, the renders encoded by it with no advanced option at
     its defaults (CDEF on there), at speed 4, at speed 2 (4:2:0, 4:4:4,
     4:0:0), RGBA at speed 4 and 2x2 tiles at speed 4, each held to that
     PIL's decode; else the three fixtures in turn, held to their
     committed hashes. The views together must use CDEF and loop
     restoration (the decoder's tools hook; each view's are printed).
     `cli.train` -r 1 for 30 iterations as in 5h, its checks and prints.
  5l. AVIF screen content, AV1's palette mode and IntraBC, after 5k: (a)
     the three committed 1080p screen-content files of
     tests/fixtures/torch_avif (PIL 12.1.0 wrote them from make_fixtures'
     desktop-like screen_picture: 4:2:0 q60 with tune-content=screen, the
     same with palette off, 4:4:4 q75), held and timed as in 5j (a), with
     the palette and IntraBC blocks each used and one decode split. (b) A
     COLMAP dataset of 7 views of trained_r5 on phase 5c's orbit at
     1920x1080: where this machine's PIL writes AVIF, the renders encoded
     by it with screen-content options (tune-content=screen at 4:2:0,
     4:4:4, 4:2:2 limited range and 2x2 tiles, IntraBC alone, PIL's
     defaults, and 4:0:0 RGBA at limited range with alpha 160 in a band,
     the path of libyuv's I400 rows), each held to that PIL's decode; else
     the three fixtures in turn, held to their committed hashes. The views
     together must use Y palette, UV palette and IntraBC (the decoder's
     tools hook; each view's are printed). A render's smooth shading need
     not reach them: where the renders alone do not, each view is encoded
     again with a seeded 640x360 panel of make_fixtures' screen_picture
     pasted at a corner, and the phase prints which it took. `cli.train`
     -r 1 for 30 iterations as in 5h, its checks and prints.
  5m. AVIF film grain and image sequences, after 5l: (a) the three
     committed 1080p files of tests/fixtures/torch_avif (PIL 12.1.0 wrote
     them: aom's grain test vector 10 at 4:2:0, `denoise-noise-level` 20
     of a textured picture at 4:4:4, an RGBA 3-frame `avis` sequence with
     grain on colour and alpha), held and timed as in 5j (a), with each
     file's film grain parameters (the decoder's tools hook) and one
     decode split with `av1_film_grain` and its share of the decode. (b) A
     COLMAP dataset of 7 views of trained_r5 on phase 5c's orbit at
     1920x1080: where this machine's PIL writes AVIF, the renders encoded
     by it with aom's grain test vectors (1 and 10 at 4:2:0, 6 at 4:2:2
     limited range, 12 at 4:4:4, 3 at 4:0:0 RGBA with alpha 160 in a
     band) and two views as `avis` sequences of the render and two renders
     shifted 8 and 16 px (RGB with vector 4, premultiplied RGBA with vector
     2), each held to that PIL's decode (frame 0 of a sequence); else the
     three fixtures in turn, held to their committed hashes. The views
     together must use luma and chroma grain, overlap_flag and a track of
     an `avis` file (each view's are printed). `cli.train` -r 1 for 30
     iterations as in 5h, its checks and prints.
  5n. JPEG arithmetic coding and lossless, after 5m: (a) the four
     committed 1080p arithmetic-coded files of tests/fixtures/torch_jpeg_arith
     (libjpeg-turbo's transcodes of PIL 12.1.0 JPEGs of trained_r5's
     renders: sequential 4:2:0 q60 with restarts, progressive 4:2:0 q55,
     4:4:4 q40 with DAC conditioning, and a 4:2:0 q95 file whose scan runs
     past the 65536 bytes PIL has read when libjpeg decodes it), held to
     PIL 12.1.0's committed reading and to this machine's PIL's (its
     libjpeg-turbo version printed): pixels, or a refusal from both; each
     read's median of 5 beside this PIL's (host clock). (b) A COLMAP
     dataset of 7 views of trained_r5 on phase 5c's orbit at 1920x1080: the
     three files read, then four renders coded lossless here by
     tests/torch_image_writers.py (RGB with predictor 1; predictor 7 with
     Pt 1; the first component sampled 2x2 with restarts and no marker;
     grey), each held to this machine's PIL's decode (without a PIL: to
     PIL 12.1.0's hashes and to the samples coded) and timed beside it.
     `cli.train` -r 1 for 30 iterations as in 5h, its checks and prints.
  5o. BLP, FTEX, GBR, FITS, FLI / FLC and ICNS, and EPS and PIL's stubs,
     after 5n: (a) one 1080p file of each form tests/torch_image_writers.py
     writes (`rare_form_files`: BLP1 of a lossless JPEG, BLP1 and BLP2
     palette, BLP2 DXT1, DXT3 and DXT5, FTEX DXT1 and raw, GBR v1 grey and
     v2 RGBA, FITS 8-bit, 16-bit and gzip table, FLC of a BRUN frame 0, and
     a 128x128 it32 + t8mk icon) and the two committed 1024x1024 icns files
     of tests/fixtures/torch_rare_forms (PIL's own icns writer's, read
     through its ic10 PNG, and an ic10 JPEG 2000 codestream PIL wrote),
     each the bytes PIL 12.1.0 read (their SHA-256) and read with its mode,
     shape and pixels' SHA-256 (sha256.json) and as this machine's PIL
     reads it; each read's median of 5 beside this PIL's median of 3 (of 1
     where PIL decodes in Python). BUFR, GRIB and HDF5 raise in the port
     and in this PIL; an EPS file is drawn as this PIL draws it where the
     machine has `gs` (printed), else both raise naming Ghostscript. (b) A
     COLMAP dataset of 7 views of trained_r5 on phase 5c's orbit at
     1920x1080: BLP1 JPEG, BLP2 DXT1, BLP2 DXT5 (alpha 255), BLP2 palette,
     FTEX DXT1, GBR v2 RGBA and FITS 8-bit grey, each held to this
     machine's PIL's reading (without a PIL: to the picture PIL's rules
     give of the writers' values) and timed beside it. `cli.train` -r 1
     for 30 iterations as in 5h, its checks and prints.
  5p. IM, IMT, IPTC, McIDAS, MSP, PCD, PIXAR, SPIDER, SUN, XBM, XPM and XV
     thumbnails, and MPEG and WMF / EMF refused, after 5o: (a) one file of
     each form tests/torch_image_writers.py writes (`pil_rest_files`, at
     1920x1080: IM RGB, YCbCr and P of a colour LUT, IMT, McIDAS 8- and
     16-bit, PIXAR, SPIDER, SUN raw BGR and RLE BGR, MSP v2, XBM, XPM of
     252 colours, an XV thumbnail; PhotoCD at 768x512 and turned to
     512x768; IPTC of raw grey), each the bytes PIL 12.1.0 read (their
     SHA-256) and read with its mode, shape and pixels' SHA-256
     (tests/fixtures/torch_pil_rest/sha256.json) and as this machine's PIL
     reads it; each read's median of 5 beside this PIL's median of 3 (of 1
     for MSP v2 and XPM, which PIL decodes in Python). MPEG, a placeable
     WMF and an EMF raise in the port, naming the format, and in this PIL.
     (b) A COLMAP dataset of 7 views of trained_r5 on phase 5c's orbit at
     1920x1080: IM RGB, SUN raw BGR, SUN RLE BGR, PIXAR, IMT grey, McIDAS
     8-bit grey and IPTC raw grey, each held to this machine's PIL's
     reading (without a PIL: to the render or its grey, the writers'
     values) and timed beside it. `cli.train` -r 1 for 30 iterations as in
     5h, its checks and prints.
  5q. AVIF grid images (libavif's tiled `grid` items), after 5p: (a) the
     committed files of tests/fixtures/torch_avif_grid (grids of 64x64
     cells at 4:2:0, 4:2:2, 4:4:4 and 4:0:0, cropped edges, RGBA with an
     alpha grid, premultiplied, limited range, 3x1, 1x3, chroma that jumps
     at every seam; a 1920x1080 grid of 2x2 cells of 960x540; a file with
     a gain map, read through its base item), held and timed as in 5j (a),
     with one decode of the 1080p grid split, the cells' copies among the
     steps; then an 8192x4608 grid (2x2 cells of 4096x2304, past AV1's
     baseline cap of 8192x4352 a frame) written by this machine's PIL's
     libavif (tests/torch_image_writers.py's avif_grid_bytes), read once
     beside that PIL and held to its reading, with the split. (b) A COLMAP
     dataset of 7 views of trained_r5 on phase 5c's orbit at 1920x1080
     (`form_dataset`), written as grids by that libavif: 2x2 of 960x540 at
     4:2:0, 2x1 of 1024x1080 with the right column cropped to 896, 3x2 of
     640x540 at 4:4:4, 4:0:0, RGBA with an alpha grid (alpha 160 in a
     band), limited range, 1x2 of 1920x540 (columns x rows); each held to
     that PIL's reading (without its libavif: the committed 1080p grid for
     each, held to PIL 12.1.0's hash) and timed beside it. `cli.train` -r
     1 for 30 iterations as in 5h, its checks and prints.
  5r. AVIF at 10 and 12 bits (AV1 high bit depth), after 5q: (a) the
     committed files of tests/fixtures/torch_avif_hbd (4:2:2 at 10 bits,
     12 bits at 4:2:0, 4:4:4 and 4:0:0, RGBA, premultiplied, restoration
     with CDEF, grids of 10- and 12-bit cells) and four 1080p fixtures of
     tests/fixtures/torch_avif relabelled here to 10 or 12 bits
     (tests/torch_image_writers.py's avif_high_depth: CDEF with
     restoration, 4:4:4 CDEF at 12 bits, film grain, IntraBC at 12 bits),
     each the bytes PIL 12.1.0 read and read with its mode, shape and
     pixels' SHA-256 (the fixtures' sha256.json), timed as in 5j (a)
     beside this machine's PIL, whose reading is printed beside the
     committed one where it differs (the port stays held to the hash);
     one decode of the relabelled 1080p CDEF file split. (b) A COLMAP
     dataset of 7 views of trained_r5 on phase 5c's orbit at 1920x1080
     (`form_dataset`), written at 8 bits by this machine's PIL and
     relabelled: 10-bit 4:2:0, 10-bit 4:4:4 (profile 1), 10-bit 4:2:2
     (profile 2), 12-bit 4:2:0 (profile 2), 10-bit 4:0:0, 10-bit RGBA
     (alpha 160 in a band), 10-bit limited range under a BT.709 `colr`;
     each held to that PIL's reading (without a PIL that writes AVIF: the
     committed 1080p fixtures relabelled, held to PIL 12.1.0's hashes) and
     timed beside it. `cli.train` -r 1 for 30 iterations as in 5h, its
     checks and prints.
  5d. sharded path (`parallel/sharding.py`), on the one card:
     - the kernels at a row origin: trained_r5 at 1920x1080 with 32x32
       tiles cut into 2 and into 4 strips of tile rows; each strip's
       clipped lists through the forward and the backward at its origin,
       held to the plain versions at the same origin by phase 3's rules
       (the cull and the replayed T included); the stitched image and
       final T bit-equal to the full frame's kernel output.
     - 2 ranks on the card over gloo (spawned processes, both on cuda:0,
       host-staged collectives): phase 5's 20 steps sharded, from the
       model padded with dead rows to a multiple of 4; every loss within
       rtol 1e-5 of phase 5's, each rank's rows after step 1 within atol
       2e-5, step 1's num_visible and num_entries equal, one launch of each
       train-path kernel per step and rank. Later steps' counts within 1e-5
       relative and denom after step 20 equal but on at most 1e-5 of the
       rows, by at most 1: a Gaussian in two strips has its gradient summed
       per strip, then over the ranks, which rounds otherwise than the one
       sum of a single device, and a few rects flip from step 2 on.
       Then `Trainer(mesh=...)` for 60 steps from 65,472 of trained_r5's
       centres at phase 5b's cameras (a densify every 5 steps from 10, the
       reset at 40): finite losses whose last 20 average below the first
       20, equal live counts on both ranks, a device densify and a host
       densify that doubled the rows, every live opacity <= 0.01 after the
       reset, one launch of each kernel per step and rank, step 1 within
       rtol 1e-5 of a single-device Trainer's, and rank 0's checkpoint in a
       single-device Trainer rendering within the forward's rule of rank
       0's render of the gathered state.
     - a one-rank NCCL group in this process: the 20 steps, with every
       step's counts and denom equal (one strip: the single-device sums).
     Prints the sharded step's median beside phase 5's (2 ranks on one
     card: not a scaling figure), peak memory per rank, the phase's wall.
  5f. bench path: `python3 bench_torch.py` (the port's bench.py) as a
     subprocess, as a user runs it, GS_BENCH_ITERS=5: render on the
     trained model (the default scene), train on it, render on `cloud`
     (262,144 random Gaussians, the early-exit worst case), render on
     the trained model with 8x8 tiles, and render on `shell` (262,144
     small opaque splats on a sphere). Each must exit 0 and print a last
     line that parses, names its metric (`render_fps_1920x1080_P122535_
     cuda_ply`, ...) and holds a finite value > 0. The same five runs in
     process (`cli.bench.main`): each kernel's counter must rise by
     exactly 4 x ITERS a run (one warm-up and three timed chains; the
     forward in both modes, the backward and the routing in train only).
     At the bench's own inputs (the trained model at 1920x1080), 32x32 and
     8x8 tiles: the forward at its render camera by the forward's rule and
     bit-equal to its unculled form, and the three train-path kernels at
     its train state and camera (`check_state`); the forward's and the
     backward's times at both geometries (CUDA events). Prints each run's
     value and frame median and the phase's wall time.
  6. profiler path: `tools/profile_stages.run` at the JAX tool's defaults
     (P = 262,144 random Gaussians, 1920x1080, 32x16 tiles, 10 calls a
     line, best of 3) over every ported stage, `comm` last with NVLink 4's
     published 450 GB/s per direction as its link rate (a specification,
     not a measurement) and the run's train step; prints the stage table,
     the header counts and the sat, roofline and comm tables. Every time must be
     finite; the launch counter of every kernel must rise by exactly the
     calls the stages report making; the entry count must equal this
     script's own preprocess of the profiler's scene. Then the three
     kernels only this path runs are timed at its shapes beside their
     bound, their plain versions and the one PyTorch call that computes
     the same (`x.t().contiguous()`, `x.sum(0)`), and `consume_t`'s
     registers per thread and resident blocks per SM.
  7. the kernels line, then the result line. Each kernel's `launches` is
     the sum of `launches_by_path`: each path's own count, read after its
     own reset (train, trainer, cli_train, cli_render, cli_blender (its
     train and render CLIs together), user_train (5g's runs A, its viewer
     frames included, and B), user_render (5g's two render CLIs),
     forms_train (5h's train CLI), dds_train (5i's train CLI),
     avif_train (5j's train CLI), avif_filters_train (5k's train CLI),
     avif_screen_train (5l's train CLI), avif_grain_train (5m's train CLI),
     jpeg_arith_train (5n's train CLI),
     rare_forms_train (5o's train CLI), pil_rest_train (5p's train CLI),
     avif_grid_train (5q's train CLI), avif_hbd_train (5r's train CLI),
     sharded_2rank and sharded_trainer (both ranks' sums), sharded_nccl1,
     bench (the five in-process runs of 5f) for the compositing kernels
     and the routing,
     profiler for the other three).

Each phase's wall time is printed. Scenes are made with numpy from fixed
seeds. Imports no JAX.
"""

import contextlib
import functools
import hashlib
import importlib.metadata
import importlib.util
import io
import json
import lzma
import math
import os
import pickle
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import types
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as torch_dist
import torch.multiprocessing as mp

from gaussian_splatting_torch import (
    OptimizationConfig, RasterizerConfig, Trainer, eval_render, init_train_state, rasterize,
    train_step,
)
from gaussian_splatting_torch.cli import metrics as metrics_cli
from gaussian_splatting_torch.cli import render as render_cli
from gaussian_splatting_torch.cli import train as train_cli
from gaussian_splatting_torch.ops import binning, gsmath, losses
from gaussian_splatting_torch.ops import lpips as lpips_mod
from gaussian_splatting_torch.cli import bench as bench_cli
from gaussian_splatting_torch.ops.composite import (
    COMPILED_TILE_GEOMETRIES, CompositeOut, blend_pair_counts, composite_bwd_torch,
    composite_fwd_torch, route_grads_torch,
)
from gaussian_splatting_torch.ops.knn import mean_knn_dist2_exact, mean_knn_dist2_morton
from gaussian_splatting_torch.ops.composite_cuda import (
    composite_bwd, composite_bwd_cuda, composite_bwd_occupancy, composite_fwd,
    composite_fwd_cuda, composite_fwd_occupancy, composite_fwd_unculled_cuda, route_grads,
    route_grads_cuda,
)
from gaussian_splatting_torch.ops.projection import preprocess
from gaussian_splatting_torch.ops.rasterize import entry_bucket_capacity
from gaussian_splatting_torch.ops.relayout import (
    relayout_to_rows, relayout_to_rows_cuda, relayout_to_rows_torch,
)
from gaussian_splatting_torch.parallel import sharding
from gaussian_splatting_torch import trainer as trainer_mod
from gaussian_splatting_torch.scene.cameras import Camera, orbit_camera
from gaussian_splatting_torch.scene.dataset_readers import (
    load_camera, read_colmap_scene, write_colmap_scene,
)
from gaussian_splatting_torch.scene.gaussians import (
    PARAM_NAMES, activate, capacity_bucket, params_from_numpy, params_from_ply, repad,
)
from gaussian_splatting_torch.scene.ply import (
    load_gaussians_ply, load_point_cloud_ply, save_gaussians_ply, save_point_cloud_ply,
)
from gaussian_splatting_torch.scene.optim import adam_update
from gaussian_splatting_torch.tools import profile_stages
from gaussian_splatting_torch.tools.consumers import (
    consume_rows, consume_rows_cuda, consume_rows_torch, consume_t, consume_t_cuda,
    consume_t_occupancy, consume_t_torch,
)
from gaussian_splatting_torch.scene import colmap
from gaussian_splatting_torch.utils import avif, cuda_build, image_io, jpeg
from gaussian_splatting_torch.trainer import _state_to_host
from gaussian_splatting_torch.viewer import network_gui
from gaussian_splatting_torch.utils.roofline import (
    OPS_PER_BLENDED_BWD, OPS_PER_PAIR, bound_ms, pair_ops,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
TRAINED_PLY = os.path.join(ROOT, "assets", "trained_r5.ply")
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
JPEG_FIXTURES = os.path.join(FIXTURES, "torch_jpeg")
IMAGE_FIXTURES = os.path.join(FIXTURES, "torch_images")
W_MAIN, H_MAIN = 1920, 1080
FRAMES = 50  # p80 has 10 frames beyond it
STEPS, TIMED_STEPS = 20, 15  # train steps; latency over the last 15 (p80 has 3 beyond it)

TRAINER_STEPS, TRAINER_CAMERAS = 300, 8
# A densify every 5 steps: at 122,535 points one densify adds a few hundred
# rows, and the run must exhaust the 8,537 free rows of the first capacity
# (131,072) to take the host path once (at a 50-step interval no densify
# of the 300 steps overflowed).
TRAINER_OPT = OptimizationConfig(densify_from_iter=5, densification_interval=5,
                                 densify_until_iter=300, opacity_reset_interval=200)

CLI_VIEWS, CLI_STEPS, CLI_REPORTS, CLI_SAVE = 16, 200, (200,), 100  # one report: its image panels are slow
CLI_JPEG_QUALITY, CLI_RESTART_VIEW = 95, 1  # the train view with a restart marker every MCU row
# train views damaged where libjpeg warns and carries on: a flipped
# entropy-coded byte in the restart view (its damage ends at the next
# restart marker), extraneous bytes before two markers in another
CLI_FLIPPED_VIEW, CLI_EXTRANEOUS_VIEW = CLI_RESTART_VIEW, 2
# three train views in the other forms capture tools and web hosts write: a
# 16-bit RGB TIFF (LZW with Predictor 2; each sample the render's value in
# its high byte), a 24-bit BMP and a lossless WebP (this script's VP8L writer)
CLI_TIFF_VIEW, CLI_BMP_VIEW, CLI_WEBP_VIEW = 3, 4, 5
# and three in the forms of scientific and game pipelines and orthophoto
# tools: a binary P6 (this script's writer), a 32-bit RLE TGA (opaque) and
# an RGB JPEG-in-TIFF (strips of CLI_JPEG_TIFF_ROWS rows, lossy)
CLI_PPM_VIEW, CLI_TGA_VIEW, CLI_JPEG_TIFF_VIEW, CLI_JPEG_TIFF_ROWS = 6, 7, 9, 16
# and two in the forms GIS and orthophoto tools write: a YCbCr JPEG-in-TIFF
# (GDAL's PHOTOMETRIC=YCBCR, 4:2:0, lossy) and a BigTIFF of LZMA planes
# (INTERLEAVE=BAND, strips of CLI_PLANAR_ROWS rows)
CLI_YCBCR_VIEW, CLI_PLANAR_VIEW, CLI_PLANAR_ROWS = 10, 11, 64
# and one in the form orthophoto programmes and satellite archives ship: a
# JPEG 2000 (the PIL-written 1080p fixture: its own picture, not the render)
CLI_JP2_VIEW = 12
# and one in the form OpenJPH writes and archives adopt: an HTJ2K codestream
# (the committed 1080p fixture of the test-side encoder, its own picture)
CLI_HT_VIEW = 13
# and one in the form of Part 2 encoders and deep scientific pipelines: a
# JPEG 2000 Part 2 codestream of 20-bit RGB samples (the committed 1080p
# fixture, its own picture)
CLI_PART2_VIEW = 14
TIFF_FORMS_FIXTURES = os.path.join(FIXTURES, "torch_tiff_forms")  # PIL-written ZSTD / LZMA, and PIL's hashes
JP2_FIXTURES = os.path.join(FIXTURES, "torch_jp2")  # PIL-written JPEG 2000 files and PIL's hashes
JP2_VIEW, JP2_FRAME = "ortho_97_rpcl_1920x1080.jp2", "frame_rgba_97_800x800.jp2"
JP2_LARGE = (JP2_VIEW, "ortho_53_1920x1080.j2k", JP2_FRAME)  # decoded and timed at full size
# JPEG 2000 Part 1 features PIL's writer never sets (tests/torch_j2k_writer.py) and PIL's hashes
JP2_PART1_FIXTURES = os.path.join(FIXTURES, "torch_jp2_part1")
JP2_PART1_LARGE = "ortho_part1_1920x1080.j2k"  # decoded and timed at full size
# HTJ2K (JPEG 2000 Part 15) files of the test-side encoder, and PIL's readings
HT_FIXTURES = os.path.join(FIXTURES, "torch_htj2k")
HT_VIEW, HT_FRAME = "ortho_ht_1920x1080.j2k", "frame_rgba_ht_800x800.jp2"  # the 1080p one decoded and timed
# JPEG 2000 Part 2 (MCT / MCC / MCO, CBD, skipped markers) and 17- to 31-bit files, and PIL's readings
PART2_FIXTURES = os.path.join(FIXTURES, "torch_jp2_part2")
PART2_VIEW, PART2_FRAME = "ortho_part2_1920x1080.j2k", "frame_rgba_part2_800x800.jp2"  # the 1080p one timed
WEBP_FIXTURES = os.path.join(FIXTURES, "torch_webp")  # 1080p files and the SHA-256 of PIL's pixels
TIFF_JPEG_FIXTURES = os.path.join(FIXTURES, "torch_tiff_jpeg")  # a PIL-written 1080p file and its SHA-256
PPM_TGA_FIXTURES = os.path.join(FIXTURES, "torch_ppm_tga")
CLI_TRAIN = ["-r", "1", "--eval", "--iterations", str(CLI_STEPS),
             "--test_iterations", *map(str, CLI_REPORTS), "--save_iterations", str(CLI_SAVE),
             "--checkpoint_iterations", str(CLI_STEPS), "--densify_from_iter", "20",
             "--densification_interval", "20", "--densify_until_iter", "160",
             "--opacity_reset_interval", "120", "--disable_viewer", "--quiet"]

# Phase 5e: nerf_synthetic/lego's layout and camera_angle_x, frames at its
# 800x800, cameras at its distance from the origin (the scene scaled so
# trained_r5's 95th-percentile radius is 1); 16 of its 100 train and 4 of
# its 200 test views, 300 of 30,000 iterations, the densify and reset
# window scaled down as phase 5c's.
BLENDER_W, BLENDER_TRAIN, BLENDER_TEST = 800, 16, 4
BLENDER_ANGLE_X, BLENDER_DIST = 0.6911112070083618, 4.0311
BLENDER_STEPS, BLENDER_REPORTS = 300, (150, 300)
BLENDER_FLAGS = ["--white_background", "--eval", "--iterations", str(BLENDER_STEPS),
                 "--test_iterations", *map(str, BLENDER_REPORTS), "--save_iterations", str(BLENDER_STEPS),
                 "--densify_from_iter", "30", "--densification_interval", "30",
                 "--densify_until_iter", "240", "--opacity_reset_interval", "180",
                 "--disable_viewer", "--quiet"]
# train frame -> its form (PNG unless named; each file named r_<i>.png, as
# the transforms file lists it, read by its signature); the others are
# 8-bit RGBA PNG, as NeRF-synthetic ships
BLENDER_FORMS = {1: "16-bit RGBA", 2: "32-bit RLE TGA with alpha", 3: "palette + tRNS", 4: "16-bit P6",
                 5: "Adam7 RGBA", 6: "16-bit planar RGBA TIFF", 7: "grey + alpha", 8: "RGBA JPEG 2000",
                 9: "RGB + tRNS colour", 10: "RGBA HTJ2K",
                 11: "CMYK JPEG", 12: "RGBA JPEG 2000 Part 2",
                 13: "32-bit BMP with alpha", 14: "palette + alpha TIFF", 15: "palette GIF + transparency"}

SUM_K = (1_900_544, 1_339_001)  # the profiler's capacity at its defaults, and an odd K
LAUNCH_COUNTERS = {"composite_fwd": composite_fwd, "composite_bwd": composite_bwd,
                   "route_grads": route_grads, "relayout_to_rows": relayout_to_rows,
                   "consume_rows": consume_rows, "consume_t": consume_t}
TRAIN_KERNELS = ("composite_fwd", "composite_bwd", "route_grads")

# phase 3's tile geometries: the compiled ones, then runtime ones (fewer
# pixels than a block of 256 threads, non-square, 480 pixels, the largest)
TILE_GEOMETRIES = COMPILED_TILE_GEOMETRIES + ((8, 8), (16, 8), (8, 16), (24, 20), (64, 64))

# Phase 5f: bench_torch.py's runs, (name, GS_BENCH_* settings), each with
# GS_BENCH_ITERS = BENCH_ITERS; a run launches each of its kernels 4 x
# BENCH_ITERS times (one warm-up and three timed chains)
BENCH_ITERS = 5
BENCH_RUNS = (("render ply", {"GS_BENCH_MODE": "render"}),
              ("train ply", {"GS_BENCH_MODE": "train"}),
              ("render cloud", {"GS_BENCH_MODE": "render", "GS_BENCH_SCENE": "cloud"}),
              ("render ply 8x8", {"GS_BENCH_MODE": "render", "GS_BENCH_TILE_W": "8",
                                  "GS_BENCH_TILE_H": "8"}),
              ("render shell", {"GS_BENCH_MODE": "render", "GS_BENCH_SCENE": "shell"}))

LOOSE, SHARE = 1e-2, 1e-3  # every pixel within LOOSE; at most SHARE over the tight bound
GRAD_L2, GRAD_ROW, GRAD_SHARE = 1e-4, 1e-3, 1e-3  # backward / routing rule, see phase 3


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def make_gaussians(P, seed, spread=1.0, scale_mu=-2.5):
    """Activated random Gaussians (the generator of tests/helpers.py)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(0, spread, (P, 3)).astype(np.float32)
    scales = np.exp(rng.normal(scale_mu, 0.3, (P, 3))).astype(np.float32)
    quats = rng.normal(0, 1, (P, 4)).astype(np.float32)
    opacities = (1 / (1 + np.exp(-rng.normal(0.5, 1, (P,))))).astype(np.float32)
    shs = rng.normal(0, 0.2, (P, 16, 3)).astype(np.float32)
    shs[:, 0, :] += 1.0
    return means, scales, quats, opacities, shs


def thin_splats_everywhere(dev, W, H, tile, seed):
    """Every tile lists the same 160 splats, thin as a line (correlation up
    to 1 - 1e-7, where the float32 conic's determinant is all rounding), of
    every opacity from 1/255 up: the box cull at its edge cases, and
    decisions that the conic's condition number puts at the mercy of
    rounding (tests/test_torch_gpu.py's generator). Returns the forward
    kernel's scene arguments."""
    rng = np.random.default_rng(seed)
    N = 160
    sigma = rng.uniform(0.5, 15.0, (N, 2))
    rho = rng.choice([0.0, 0.9, -0.999, 0.99999, -0.9999999], N)
    det = (sigma[:, 0] * sigma[:, 1]) ** 2 * (1 - rho ** 2)
    conic = np.stack([sigma[:, 1] ** 2, -rho * sigma[:, 0] * sigma[:, 1], sigma[:, 0] ** 2], 1)
    num_tiles = -(-W // tile[0]) * -(-H // tile[1])
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    return (torch.arange(N, **i32).repeat(num_tiles), torch.arange(num_tiles, **i32) * N,
            torch.arange(1, num_tiles + 1, **i32) * N,
            torch.tensor(rng.uniform([-4, -4], [W + 4, H + 4], (N, 2)), **f32),
            torch.tensor(conic / det[:, None], **f32), torch.tensor(rng.uniform(0, 1, (N, 3)), **f32),
            torch.tensor(rng.uniform(1 / 255, 1.0, N), **f32))


def sorted_inputs(acts, cam, W, H, tile, sh=3, alive=None, capacity=None):
    """Preprocess + binning once; the kernels' inputs at exactly this size
    (rows outside `alive` culled, as the train step does; the entry
    capacity `capacity`, or the exact entry count when that is None or
    smaller). Returns the forward kernel's scene arguments, the tile lists
    and the entry count."""
    P = acts[0].shape[0]
    prep = preprocess(*acts, sh, cam, W, H, *tile, alive=alive)
    gx, gy = -(-W // tile[0]), -(-H // tile[1])
    capacity = max(capacity or 0, int(prep.tiles_touched.sum()))
    capacity = RasterizerConfig(capacity_exact=capacity).capacity(P)
    lists = binning.build_tile_lists(prep.rect_min, prep.rect_max, prep.depths,
                                     prep.tiles_touched, gx, gy, capacity)
    if int(lists.total) > capacity:
        fail("tile list overflow in the kernel check")
    return (lists.gauss_id, lists.tile_start, lists.tile_stop, prep.means2d, prep.conic,
            prep.rgb, prep.opacity), lists, int(lists.total)


def compare(name, out, ref, tight):
    """Check a render against a reference; returns the max abs error."""
    errs = []
    for field in ("image", "final_t"):
        a, b = getattr(out, field), getattr(ref, field)
        if a.shape != b.shape:
            fail(f"{name}: {field} shape {tuple(a.shape)} vs {tuple(b.shape)}")
        if not bool(torch.isfinite(a).all()):
            fail(f"{name}: {field} not finite")
        d = (a - b).abs()
        per_pixel = d.amax(dim=-1) if field == "image" else d
        over = float((per_pixel > tight).float().mean())
        mx = float(d.max())
        print(f"  {name:34s} {field:7s} max_abs_err={mx:.3e} share_over_{tight:g}={over:.2e}")
        if mx > LOOSE or over > SHARE:
            fail(f"{name}: {field} outside tolerance (max {mx:.3e}, share {over:.2e})")
        errs.append(mx)
    return max(errs)


def check_cull(name, out, args, bg, W, H, tile, origin_y=0):
    """The forward kernel's outputs must be the bits of its form with the
    box cull off: the cull may leave out only pairs the blend skips."""
    full = composite_fwd_unculled_cuda(*args, bg, W, H, *tile, origin_y=origin_y)
    torch.cuda.synchronize()
    for field in ("image", "final_t"):
        a, b = getattr(out, field), getattr(full, field)
        if not torch.equal(a, b):
            fail(f"{name}: the box cull changes {field} at {int((a != b).sum())} elements")
    print(f"  {name:34s} image and final_t bit-equal with the box cull off")


def compare_grads(name, got, ref):
    """Check (N, 9) gradient rows against a reference, field by field;
    returns the max abs error."""
    if got.shape != ref.shape:
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: not finite")
    worst_l2 = worst_share = 0.0
    for f in range(ref.shape[1]):
        d, r = (got[:, f] - ref[:, f]).double(), ref[:, f].double()
        l2 = float(d.norm()) / max(float(r.norm()), 1e-30)
        share = float((d.abs() > GRAD_ROW * float(r.abs().max())).double().mean())
        worst_l2, worst_share = max(worst_l2, l2), max(worst_share, share)
    mx = float((got - ref).abs().max())
    print(f"  {name:42s} max_abs_err={mx:.3e} worst_field_rel_l2={worst_l2:.2e} "
          f"worst_field_share_over={worst_share:.2e}")
    if worst_l2 > GRAD_L2 or worst_share > GRAD_SHARE:
        fail(f"{name}: outside tolerance (rel L2 {worst_l2:.2e}, share {worst_share:.2e})")
    return mx


def check_backward(name, args, lists, bg, W, H, tile, seed, origin_y=0):
    """Backward and routing kernels vs their plain versions on the forward
    kernel's outputs and seeded random cotangents; the replayed final T must
    be the forward's, and two runs of each kernel the same bits. Returns
    the max abs errors of the backward's rows and of the routing's sums."""
    dev = bg.device
    fwd = composite_fwd_cuda(*args, bg, W, H, *tile, origin_y=origin_y)
    gen = torch.Generator(device=dev).manual_seed(seed)
    g_img = torch.randn((H, W, 3), generator=gen, device=dev)
    g_ft = torch.randn((H, W), generator=gen, device=dev)
    bargs = (*args[:3], lists.entry_src, *args[3:], fwd.image, fwd.final_t, g_img, g_ft, W, H, *tile)
    replay_t = torch.full((H, W), -1.0, device=dev)
    rows = composite_bwd_cuda(*bargs, origin_y=origin_y, replay_t=replay_t)
    rows_again = composite_bwd_cuda(*bargs, origin_y=origin_y)
    torch.cuda.synchronize()
    if not torch.equal(replay_t, fwd.final_t):
        n_diff = int((replay_t != fwd.final_t).sum())
        fail(f"{name}: the backward's replayed final T differs from the forward's at {n_diff} pixels")
    n, P = int(lists.total), args[3].shape[0]  # rows past n: padding, never written or read
    if not torch.equal(rows[:n], rows_again[:n]):
        fail(f"{name}: two runs of the backward kernel differ")
    rows_ref = composite_bwd_torch(*bargs, origin_y=origin_y)
    err_rows = compare_grads(f"{name} backward rows", rows[:n], rows_ref[:n])
    off, cnt = lists.gauss_offset, lists.gauss_count
    sums = route_grads_cuda(rows, off, cnt, P)
    if not torch.equal(sums, route_grads_cuda(rows, off, cnt, P)):
        fail(f"{name}: two runs of the routing kernel differ")
    err_route = compare_grads(f"{name} routing", sums, route_grads_torch(rows, off, cnt, P))
    compare_grads(f"{name} backward+routing", sums, route_grads_torch(rows_ref, off, cnt, P))
    return err_rows, err_route


def check_state(name, params, sh, cam, bg, capacity, tile, seed, W=W_MAIN, H=H_MAIN):
    """The three train-path kernels against their plain versions at a
    training state's own preprocess and binning (its live rows, its SH
    degree and entry capacity) and a W x H camera: the forward within the
    forward's rule and bit-equal to its unculled form, then check_backward.
    Returns the max abs errors of the forward, the backward's rows and the
    routing."""
    with torch.no_grad():
        args, lists, total = sorted_inputs(tuple(activate(params)), cam, W, H, tile,
                                           sh=sh, alive=params.alive, capacity=capacity)
        out = composite_fwd_cuda(*args, bg, W, H, *tile)
        ref = composite_fwd_torch(*args, bg, W, H, *tile)
    torch.cuda.synchronize()
    counts = blend_pair_counts(*args, W, H, *tile)
    print(f"  {name}: {W}x{H}, K={total} entries, pairs {counts.pairs}, taken {counts.taken}, blended "
          f"{counts.blended} ({counts.blended / max(counts.pairs, 1):.1%} of the evaluated pairs)")
    err_fwd = compare(f"{name} K={total}", out, ref, 1e-5)
    check_cull(name, out, args, bg, W, H, tile)
    return (err_fwd, *check_backward(name, args, lists, bg, W, H, tile, seed))


def cuda_time_ms(fn, reps):
    """Mean device time of fn() over `reps` back-to-back calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def stage_times_ms(params, cam, bg, cfg, frames=10):
    """Host-clock time of each stage of eval_render's path run alone: the
    device is synchronized before and after every stage, so a stage's time
    is its enqueue and its device work with nothing overlapped. Median over
    `frames` frames."""
    gx, gy = -(-W_MAIN // cfg.tile_w), -(-H_MAIN // cfg.tile_h)
    times = {n: [] for n in ("activate", "preprocess", "binning", "composite")}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        return out

    with torch.no_grad():
        for _ in range(frames):
            acts = timed("activate", lambda: activate(params))
            prep = timed("preprocess", lambda: preprocess(
                acts.xyz, acts.scales, acts.quats, acts.opacities, acts.shs, 3, cam,
                W_MAIN, H_MAIN, cfg.tile_w, cfg.tile_h, alive=params.alive))
            lists = timed("binning", lambda: binning.build_tile_lists(
                prep.rect_min, prep.rect_max, prep.depths, prep.tiles_touched, gx, gy,
                cfg.capacity(params.num_points)))
            timed("composite", lambda: composite_fwd(
                lists, prep.means2d, prep.conic, prep.rgb, prep.opacity, bg,
                W_MAIN, H_MAIN, cfg.tile_w, cfg.tile_h))
    return {n: float(np.median(t)) for n, t in times.items()}


def device_busy_ms(run_once, reps=5):
    """torch.profiler over `reps` calls of run_once(): device (kernel + copy)
    time and device activities per call, and the top kernels by device
    time. None if the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run_once()
        torch.cuda.synchronize()
    per_name, n_events = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            n_events += 1
    if not per_name:
        return None, 0, []
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    return sum(per_name.values()) / reps, n_events / reps, [(n, t / reps) for n, t in top]


def print_busy(busy, per_call, top, call_ms, unit):
    if busy is None:
        print("  device busy share: not measured (the profiler saw no device activity)")
        return
    print(f"  device busy {busy:.3f} ms per {unit} in {per_call:.0f} device activities "
          f"(torch.profiler) = {busy / call_ms:.1%} of the {unit}; idle {1 - busy / call_ms:.1%}")
    for name, t in top:
        print(f"    {t:8.4f} ms  {name[:110]}")


def train_stage_times_ms(state, cam, gt, bg, cfg, opt, steps=5):
    """Stream time (CUDA events) of each stage of a train step run alone,
    the device synchronized between stages: forward (activate + rasterize),
    loss, backward (autograd through the kernels), Adam. Median over
    `steps` steps; the state takes those steps."""
    params = state.params
    times = {n: [] for n in ("forward", "loss", "backward", "adam")}

    def timed(name, fn):
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        times[name].append(start.elapsed_time(stop))
        return out

    for _ in range(steps):
        bias = torch.zeros((params.num_points, 2), device=gt.device, requires_grad=True)

        def forward():
            a = activate(params)
            return rasterize(a.xyz, a.scales, a.quats, a.opacities, a.shs, 3, cam, W_MAIN,
                             H_MAIN, bg, cfg, mean2d_bias=bias, alive=params.alive)

        img, _ = timed("forward", forward)
        loss = timed("loss", lambda: (1 - opt.lambda_dssim) * losses.l1_loss(img, gt)
                     + opt.lambda_dssim * (1 - losses.ssim(img, gt)))
        grads = timed("backward", lambda: torch.autograd.grad(
            loss, [getattr(params, k) for k in PARAM_NAMES] + [bias]))
        lrs = {"xyz": opt.position_lr_init, "features_dc": opt.feature_lr,
               "features_rest": opt.feature_lr / 20, "scaling": opt.scaling_lr,
               "rotation": opt.rotation_lr, "opacity": opt.opacity_lr}
        timed("adam", lambda: adam_update(params, dict(zip(PARAM_NAMES, grads)), state.adam,
                                          lrs, params.alive))
    return {n: float(np.median(t)) for n, t in times.items()}


def reset_launches():
    for counter in LAUNCH_COUNTERS.values():
        counter.launches = 0


def check_transpose_and_sums(dev):
    """The transpose bit-equal to its plain version; the column sums within
    1e-5 x sum |x| of a float64 sum per column, kernel and plain version
    alike, and each kernel bit-identical across two runs. Returns the max
    abs errors of the three kernels against their plain versions."""
    gen = torch.Generator(device=dev).manual_seed(30)
    err = {"relayout_to_rows": 0.0, "consume_rows": 0.0, "consume_t": 0.0}
    for K in SUM_K:
        for R in (9, 16):
            x = torch.randn((R, K), generator=gen, device=dev)
            got, ref = relayout_to_rows_cuda(x), relayout_to_rows_torch(x)
            torch.cuda.synchronize()
            if got.shape != (K, R) or not torch.equal(got, ref):
                fail(f"relayout_to_rows ({R}, {K}) is not bit-equal to x.t().contiguous()")
            print(f"  relayout_to_rows ({R}, {K}) bit-equal to its plain version")
        x = torch.randn((K, 16), generator=gen, device=dev)
        exact = x.double().sum(0)
        tol = 1e-5 * x.double().abs().sum(0)
        for name, kern, plain in (("consume_rows", consume_rows_cuda, consume_rows_torch),
                                  ("consume_t", consume_t_cuda, consume_t_torch)):
            a, b, ref = kern(x), kern(x), plain(x)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                fail(f"{name} ({K}, 16): two runs differ")
            worst = 0.0
            for what, v in (("kernel", a), ("plain", ref)):
                d = (v.double().reshape(16) - exact).abs()
                worst = max(worst, float((d / tol).max()))
                if not bool((d <= tol).all()):
                    fail(f"{name} ({K}, 16): {what} off the float64 sum by {float(d.max()):.3e}")
            e = float((a - ref).abs().max())
            err[name] = max(err[name], e)
            print(f"  {name} ({K}, 16) max_abs_err vs plain {e:.3e}; worst column "
                  f"{worst:.2e} x its 1e-5 sum|x| limit; two runs bit-identical")
    return err


def trainer_cameras(pts):
    """Phase 5b's cameras: TRAINER_CAMERAS orbit views at 1920x1080 around
    the trained model's centres `pts`, each with the model's render as its
    target; and their extent."""
    trained = params_from_ply(TRAINED_PLY)
    bg0 = torch.zeros(3, device=trained.xyz.device)
    center = pts.mean(axis=0)
    dist = 2.5 * float(np.quantile(np.linalg.norm(pts - center, axis=1), 0.95))
    cams = [orbit_camera(center, dist, 2 * math.pi * i / TRAINER_CAMERAS, W_MAIN, H_MAIN, 70.0,
                         70.0 * H_MAIN / W_MAIN) for i in range(TRAINER_CAMERAS)]
    with torch.no_grad():
        acts = tuple(activate(trained))
        for cam in cams:
            arr = cam.arrays()
            n = int(preprocess(*acts, 3, arr, W_MAIN, H_MAIN, 32, 32).tiles_touched.sum())
            img = eval_render(trained, arr, bg0, 3, W_MAIN, H_MAIN,
                              RasterizerConfig(capacity_exact=entry_bucket_capacity(n, 16, 1.2)))[0]
            cam.image = img.clamp(0.0, 1.0).permute(2, 0, 1).cpu().numpy()
    centers = np.stack([c.camera_center for c in cams]).astype(np.float64)
    extent = 1.1 * float(np.linalg.norm(centers - centers.mean(axis=0), axis=1).max())
    return cams, extent


def trainer_phase(dev, bare_step_ms):
    """Phase 5b: the host training loop from a point cloud at 1920x1080.
    Returns the three train-path kernels' launches and their max abs errors
    against their plain versions at the trainer's states."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        return _trainer_phase(dev, bare_step_ms, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def synced_ms(fn, *args):
    """fn(*args) on the host clock between two device waits; (out, ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _trainer_phase(dev, bare_step_ms, tmp):
    bg0 = torch.zeros(3, device=dev)
    # The point cloud: the trained model's centres, coloured by its DC term,
    # through the point-cloud PLY functions.
    model = load_gaussians_ply(TRAINED_PLY)
    colors = np.clip(0.5 + gsmath.SH_C0 * model["features_dc"][:, 0, :], 0.0, 1.0)
    save_point_cloud_ply(os.path.join(tmp, "points3d.ply"), model["xyz"], colors)
    pts, cols, _ = load_point_cloud_ply(os.path.join(tmp, "points3d.ply"))
    if not np.array_equal(pts, model["xyz"]) or float(np.abs(cols - colors).max()) > 1 / 255:
        fail("trainer path: the point cloud did not survive its PLY round trip")

    cams, extent = trainer_cameras(pts)

    def new_trainer(raster_cfg=RasterizerConfig(tile_w=32, tile_h=32)):
        return Trainer(cameras=cams, opt=TRAINER_OPT, raster_cfg=raster_cfg, sh_degree=3,
                       cameras_extent=extent, spatial_lr_scale=extent, seed=0)

    # The KNN's two forms on the card.
    pts_t = torch.from_numpy(pts).to(dev)
    morton_ms = cuda_time_ms(lambda: mean_knn_dist2_morton(pts_t), 5)
    exact_ms = cuda_time_ms(lambda: mean_knn_dist2_exact(pts_t[:20_000]), 3)
    del pts_t

    tr = new_trainer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, init_ms = synced_ms(tr.init_from_pcd, pts, cols)
    if tr.state.params.num_points != capacity_bucket(pts.shape[0]) or tr.num_live != pts.shape[0]:
        fail(f"trainer path: init gave {tr.num_live} live rows of {tr.state.params.num_points}")

    def probe(cam):  # the first step's entry probe: a preprocess-only count of the live rows
        with torch.no_grad():
            p = tr.state.params
            return int(preprocess(*activate(p), tr.active_sh_degree, cam.arrays(), W_MAIN, H_MAIN,
                                  32, 32, alive=p.alive).tiles_touched.sum())

    probe(cams[0])
    probe_n, probe_ms = synced_ms(probe, cams[0])

    max_err = {"composite_fwd": 0.0, "composite_bwd": 0.0, "route_grads": 0.0}

    def check_kernels(name, seed):  # the kernels at the state the next step renders
        p = tr.state.params
        errs = check_state(name, p, tr.active_sh_degree, cams[seed % TRAINER_CAMERAS].arrays(),
                           tr.background, tr.raster_cfg.capacity(p.num_points), (32, 32), seed)
        for k, e in zip(max_err, errs):
            max_err[k] = max(max_err[k], e)

    reset_at = TRAINER_OPT.opacity_reset_interval
    reset_launches()
    step_ms, post_ms, rows_before = {}, {}, {}
    for _ in range(TRAINER_STEPS):
        cfg_before = tr.raster_cfg
        rows = tr.state.params.num_points
        m, ms = synced_ms(tr.step, True)
        step_ms[tr.iteration] = ms
        # the first step ran at the capacity its probe set, which a growth
        # right after it replaced: the rule below then reads `after` twice
        ran_at = (cfg_before if cfg_before.capacity_exact is not None else tr.raster_cfg).capacity(rows)
        after = tr.raster_cfg.capacity(rows)
        entries = int(m["num_entries"])
        if not (entries <= ran_at or after >= entries):
            fail(f"trainer path: step {tr.iteration} had {entries} entries at capacity {ran_at} "
                 f"and the capacity did not grow to hold them ({after})")
        rows_before[tr.iteration] = tr.state.params.num_points
        post_ms[tr.iteration] = synced_ms(tr.post_step)[1]
        if tr.iteration == reset_at:
            p = tr.state.params
            top = float(torch.sigmoid(p.opacity.detach()[p.alive]).max())
            if top > 0.01:
                fail(f"trainer path: a live opacity of {top} after the reset")
            # opacities <= 0.01: T never saturates and nearly every pair blends
            launches_so_far = {k: LAUNCH_COUNTERS[k].launches for k in max_err}
            check_kernels(f"trainer after the reset at {reset_at}", 41)
            for k, n in launches_so_far.items():  # the check's launches are not the path's
                LAUNCH_COUNTERS[k].launches = n
    torch.cuda.synchronize()
    launches = {k: LAUNCH_COUNTERS[k].launches for k in max_err}
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    hist = tr.history
    step_losses = [h["loss"] for h in hist]
    first20, last20 = float(np.mean(step_losses[:20])), float(np.mean(step_losses[-20:]))
    densified = {d["iteration"]: d for d in tr.densify_history}
    maintenance = set(densified) | set(range(reset_at, TRAINER_STEPS + 1, reset_at))
    quiet = [ms for it, ms in step_ms.items() if it > TRAINER_CAMERAS and it not in maintenance]
    print(f"trainer path: {pts.shape[0]} points from their PLY at {W_MAIN}x{H_MAIN}, "
          f"{TRAINER_CAMERAS} cameras, extent {extent:.4f}, {TRAINER_STEPS} steps; "
          f"launches {launches}; peak device memory {peak_mib:.1f} MiB")
    print(f"  loss {step_losses[0]:.6f} -> {step_losses[-1]:.6f} (mean of the first 20 {first20:.6f}, "
          f"last 20 {last20:.6f}), psnr {hist[0]['psnr']:.3f} -> {hist[-1]['psnr']:.3f} dB; "
          f"live {tr.num_live} of {tr.state.params.num_points} rows; entries "
          f"{int(hist[0]['num_entries'])} -> {int(hist[-1]['num_entries'])}, entry capacity "
          f"{tr.raster_cfg.capacity_exact}")
    print(f"  step latency median {np.median(quiet):.3f} ms, p80 {np.percentile(quiet, 80):.3f} ms "
          f"({len(quiet)} steps after the first epoch that ran no maintenance, host clock, each "
          f"ending in a synchronize); phase 5's bare train_step median {bare_step_ms:.3f} ms")
    for d in tr.densify_history:
        print(f"  densify at {d['iteration']}: {d['path']}, cloned {d['n_cloned']}, split "
              f"{d['n_split']}, pruned {d['n_pruned']}, live {d['live_before']} -> "
              f"{d['live_after']}, rows {d['rows_before']} -> {d['capacity']}, {d['ms']:.3f} ms")
    reset_ms = post_ms[reset_at] - (densified[reset_at]["ms"] if reset_at in densified else 0.0)
    print(f"  reset {reset_ms:.3f} ms (post_step at {reset_at} {post_ms[reset_at]:.3f} ms less its "
          f"densify); probe {probe_ms:.3f} ms ({probe_n} entries, camera 0); create_from_pcd "
          f"{init_ms:.3f} ms; KNN Morton at {pts.shape[0]} points {morton_ms:.3f} ms, exact at "
          f"20000 {exact_ms:.3f} ms")

    if any(n != TRAINER_STEPS for n in launches.values()):
        fail(f"trainer path launches {launches} for {TRAINER_STEPS} steps")
    if not all(math.isfinite(x) for x in step_losses):
        fail("trainer path: a loss is not finite")
    if not last20 < first20:
        fail(f"trainer path: the loss did not fall (first 20 {first20}, last 20 {last20})")
    paths = [d["path"] for d in tr.densify_history]
    grew = [d for d in tr.densify_history if d["path"] == "host" and d["capacity"] > d["rows_before"]]
    if "device" not in paths or not grew:
        fail(f"trainer path: densify paths {paths}; a device densify and a host densify that "
             f"grew the capacity are both needed")
    p = tr.state.params
    dead_inside = int((~p.alive[: int(torch.nonzero(p.alive).max()) + 1]).sum())
    print(f"  final state: {dead_inside} dead rows among the live ones")
    check_kernels("trainer final state", 42)

    # A checkpoint saved on the card, loaded into a fresh trainer and saved
    # again: the two files hold the same live rows, moments, step and
    # statistics, bit for bit.
    ckpt, ckpt2 = os.path.join(tmp, "ckpt.pkl"), os.path.join(tmp, "ckpt2.pkl")
    _, save_ms = synced_ms(tr.save_checkpoint, ckpt)
    tr2 = new_trainer(tr.raster_cfg)
    _, load_ms = synced_ms(tr2.load_checkpoint, ckpt)
    tr2.save_checkpoint(ckpt2)
    with open(ckpt, "rb") as f:  # this run's own files
        mine = pickle.load(f)
    with open(ckpt2, "rb") as f:
        theirs = pickle.load(f)
    for what in ("params", "adam_m", "adam_v", "stats"):
        for k in mine[what]:
            if not np.array_equal(mine[what][k], theirs[what][k]):
                fail(f"trainer path: checkpoint {what}[{k}] differs after the reload")
    if mine["adam_step"] != theirs["adam_step"] or tr2.iteration != tr.iteration:
        fail("trainer path: checkpoint step or iteration differs after the reload")
    more = tr2.step()
    if not math.isfinite(more["loss"]):
        fail("trainer path: the reloaded trainer's step is not finite")
    print(f"  checkpoint of {tr.num_live} rows: save {save_ms:.1f} ms, load {load_ms:.1f} ms, "
          f"{os.path.getsize(ckpt) / 2**20:.1f} MiB; bit-equal after the reload; one more step, "
          f"loss {more['loss']:.6f}")
    del tr2

    # The trained live rows as a PLY model, reloaded and rendered.
    save_gaussians_ply(os.path.join(tmp, "model.ply"), mine["params"])
    reloaded = params_from_ply(os.path.join(tmp, "model.ply"))
    arr = cams[0].arrays()
    with torch.no_grad():
        n = int(preprocess(*activate(tr.state.params), 3, arr, W_MAIN, H_MAIN, 32, 32,
                           alive=tr.state.params.alive).tiles_touched.sum())
    cfg = RasterizerConfig(capacity_exact=entry_bucket_capacity(n, 16, 1.2))
    ours = eval_render(tr.state.params, arr, bg0, 3, W_MAIN, H_MAIN, cfg)
    back = eval_render(reloaded, arr, bg0, 3, W_MAIN, H_MAIN, cfg)
    torch.cuda.synchronize()
    compare("trainer PLY reload vs trainer", CompositeOut(back[0], back[1]["final_t"]),
            CompositeOut(ours[0], ours[1]["final_t"]), 1e-5)
    return launches, max_err


def quantize(img):
    """(H, W, 3) image on the card -> uint8, as the render CLI writes it."""
    return render_cli.quantize(img.cpu().numpy())


def png_form(samples, depth, color, interlace=False, plte=None, trns=None, filters=(1,)) -> bytes:
    """PNG bytes of integer samples (H, W, spp) at 8 or 16 bits in PNG
    colour type `color` (Adam7 when `interlace`d), with PLTE and tRNS
    chunks; row i of each pass takes row filter filters[i % len(filters)]
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), by the PNG specification's
    formulas, compressed at zlib's default level. This script's writer for
    what image_io.write_png does not write: the forms PIL reads, and rows
    mixed as adaptive encoders such as libpng's mix them."""
    bpp = samples.shape[2] * depth // 8

    def rows(a):
        h = a.shape[0]
        x = (a.astype(">u2").view(np.uint8) if depth == 16 else a.astype(np.uint8)).reshape(h, -1)
        x = x.astype(np.int16)
        up = np.concatenate([np.zeros_like(x[:1]), x[:-1]])
        left = np.pad(x, ((0, 0), (bpp, 0)))[:, :-bpp]
        upleft = np.pad(up, ((0, 0), (bpp, 0)))[:, :-bpp]
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        kind = np.asarray(filters)[np.arange(h) % len(filters)]
        pred = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, paeth])[kind, np.arange(h)]
        return np.concatenate([kind[:, None].astype(np.uint8), ((x - pred) & 255).astype(np.uint8)],
                              axis=1).tobytes()

    passes = image_io.ADAM7 if interlace else ((0, 0, 1, 1),)
    data = b"".join(rows(samples[y0::dy, x0::dx]) for x0, y0, dx, dy in passes
                    if samples[y0::dy, x0::dx].size)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    h, w = samples.shape[:2]
    header = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace))
    return (image_io.PNG_SIGNATURE + chunk(b"IHDR", header) + (chunk(b"PLTE", plte) if plte else b"")
            + (chunk(b"tRNS", trns) if trns else b"") + chunk(b"IDAT", zlib.compress(data))
            + chunk(b"IEND", b""))


# ---- a baseline JPEG encoder, for the CLI phase's dataset ----
# The port reads JPEG but writes none (the JAX package writes no JPEG), so
# this script keeps its own encoder; tests/test_torch_jpeg.py copies it.

ENC_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# JPEG Annex K: the example quantisation tables (K.1, K.2; natural order) and
# Huffman tables (K.3 to K.6): code counts per length, then symbols. The AC
# tables list a few symbols by hand, then every other (run, size) in order.
Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
Q_CHROMA = np.full(64, 99)
Q_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56,
                                                         47, 66]
_AC_SYMBOLS = [0x00, 0xF0] + [r << 4 | s for r in range(16) for s in range(1, 11)]


def _ac_symbols(head_hex):
    head = list(bytes.fromhex(head_hex))
    return head + sorted(set(_AC_SYMBOLS) - set(head))


HUFFMAN = {  # (class, table id): (counts of lengths 1..16, symbols)
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125], _ac_symbols(
        "01020300041105122131410613516107227114328191a108234" "2b1c11552d1f02433627282090a16")),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119], _ac_symbols(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f1")),
}


def _scaled(table, quality):
    """libjpeg's jpeg_quality_scaling and jpeg_add_quant_table (baseline)."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((table * scale + 50) // 100, 1, 255)


def _codes(counts, symbols):
    """Canonical Huffman codes: code and length per symbol (256 entries)."""
    code, length = np.zeros(256, np.int64), np.zeros(256, np.int64)
    c, p = 0, 0
    for n in range(1, 17):
        for _ in range(counts[n - 1]):
            code[symbols[p]], length[symbols[p]] = c, n
            c, p = c + 1, p + 1
        c <<= 1
    return code, length


def _pack(values, lengths):
    """Bits (each value's `length` low bits, most significant first) as
    bytes, the last byte padded with ones; every value <= 32 bits."""
    ends = np.cumsum(lengths)
    starts = ends - lengths
    nbits = int(ends[-1]) if len(ends) else 0
    word, off = starts // 32, starts % 32
    window = values.astype(np.uint64) << (64 - off - lengths).astype(np.uint64)
    hi = (window >> np.uint64(32)).astype(np.float64)
    lo = (window & np.uint64(0xFFFFFFFF)).astype(np.float64)
    n_words = nbits // 32 + 2
    words = (np.bincount(word, hi, n_words) + np.bincount(word + 1, lo, n_words)).astype(np.uint64)
    data = bytearray(words.astype(">u4").tobytes()[:(nbits + 7) // 8])
    if nbits % 8:
        data[-1] |= (1 << (8 - nbits % 8)) - 1
    return bytes(data).replace(b"\xff", b"\xff\x00")


# the table (quantisation and Huffman) of each component: luma for Y (or
# C) and K, chroma for the other two
TABLE_OF = np.array([0, 1, 1, 0])


def _entropy(coefs, comp, tables):
    """Huffman-code quantised blocks (B, 64, zig-zag order) of one
    restart segment, `comp` the component of each block: DC differences
    per component, AC as (run, size) symbols with ZRL and EOB; each
    component's tables by TABLE_OF."""
    B = len(coefs)
    dc = coefs[:, 0]
    diff = np.empty(B, np.int64)
    for c in np.unique(comp):
        idx = np.nonzero(comp == c)[0]
        diff[idx] = np.diff(dc[idx], prepend=0)
    comp = TABLE_OF[comp]
    b_idx, k = np.nonzero(coefs[:, 1:])
    k = k + 1
    first = np.ones(len(k), bool)
    first[1:] = b_idx[1:] != b_idx[:-1]
    prev = np.where(first, 0, np.roll(k, 1))
    run = k - prev - 1
    last = np.zeros(B, np.int64)
    last[b_idx] = k  # the last nonzero index of each block (0: none)
    eob_blocks = np.nonzero(last < 63)[0]
    zrl_of = np.repeat(np.arange(len(k)), run // 16)

    def size(x):
        return np.where(x == 0, 0, np.floor(np.log2(np.maximum(np.abs(x), 1))).astype(np.int64) + 1)

    def extra(x, s):
        return np.where(x < 0, x + (1 << s) - 1, x)

    s_dc = size(diff)
    ac_val = coefs[b_idx, k]
    s_ac = size(ac_val)
    sym = (run % 16) << 4 | s_ac
    dc_code, dc_len = (np.array([t[0][i] for t in tables]) for i in range(2))  # (2, 256) each
    ac_code, ac_len = (np.array([t[1][i] for t in tables]) for i in range(2))
    cb = comp[b_idx]
    keys = np.concatenate([np.arange(B) * 130, b_idx[zrl_of] * 130 + 2 * k[zrl_of] - 1,
                           b_idx * 130 + 2 * k, eob_blocks * 130 + 129])
    ce, cz = comp[eob_blocks], comp[b_idx[zrl_of]]
    values = np.concatenate([
        (dc_code[comp, s_dc] << s_dc) | extra(diff, s_dc), ac_code[cz, 0xF0],
        (ac_code[cb, sym] << s_ac) | extra(ac_val, s_ac), ac_code[ce, 0x00]])
    lengths = np.concatenate([dc_len[comp, s_dc] + s_dc, ac_len[cz, 0xF0], ac_len[cb, sym] + s_ac, ac_len[ce, 0x00]])
    order = np.argsort(keys, kind="stable")
    return _pack(values[order], lengths[order])


def encode_jpeg(pixels, quality=95, sampling=(2, 2), restart_interval=0, adobe=None, k_sampled=False,
                raw=False):
    """Baseline bytes of (H, W, 3), (H, W[, 1]) or (H, W, 4) uint8 `pixels`:
    the first component sampled (h, v) = `sampling` times the second and
    third's, a float DCT, the Annex K tables at libjpeg's `quality`
    scaling, and `restart_interval` MCUs between restart markers (0: none).
    3 channels are RGB, written as YCbCr under a JFIF marker. 4 channels
    are CMYK as libjpeg takes it (the samples the file stores for CMYK):
    with `adobe` 2 written as YCCK (libjpeg's cmyk_ycck_convert: YCbCr of
    255 - C, 255 - M, 255 - Y, K kept) under an Adobe marker of transform
    2, else as stored, under an Adobe marker of transform `adobe` (0) or
    none (None); K sampled as the first component, or as the second and
    third where `k_sampled`. `raw`: the channels as components, unsampled,
    without a JFIF or Adobe marker (what libtiff writes for an RGB TIFF)."""
    a = np.asarray(pixels, np.float64)
    a = a[..., None] if a.ndim == 2 else a
    H, W, C = a.shape
    grey = C == 1
    hs, vs = (1, 1) if grey or raw else sampling
    mcux, mcuy = -(-W // (8 * hs)), -(-H // (8 * vs))
    a = np.pad(a, ((0, mcuy * 8 * vs - H), (0, mcux * 8 * hs - W), (0, 0)), mode="edge")
    factors = [(hs, vs)] + [(1, 1)] * min(C - 1, 2) + ([(1, 1) if k_sampled else (hs, vs)] if C == 4 else [])
    if grey or raw:
        planes = [a[..., i] for i in range(C)]
    else:
        if C == 4 and adobe != 2:
            planes = [a[..., i] for i in range(4)]
        else:
            r, g, b = (255 - a[..., i] if C == 4 else a[..., i] for i in range(3))
            y = 0.299 * r + 0.587 * g + 0.114 * b
            cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
            cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
            planes = [y, cb, cr] + ([a[..., 3]] if C == 4 else [])
        planes = [p if f == (hs, vs) else p.reshape(mcuy * 8, vs, mcux * 8, hs).mean(axis=(1, 3))
                  for p, f in zip(planes, factors)]
    qts = [_scaled(Q_LUMA, quality), _scaled(Q_CHROMA, quality)]
    x = np.arange(8)
    M = np.sqrt(np.where(x[:, None] == 0, 1 / 8, 2 / 8)) * np.cos((2 * x[None, :] + 1) * x[:, None] * np.pi / 16)
    blocks = []
    for i, p in enumerate(planes):
        rows, cols = p.shape[0] // 8, p.shape[1] // 8
        t = (p - 128).reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3)
        f = M @ t @ M.T
        q = np.round(f.reshape(rows, cols, 64) / qts[TABLE_OF[i]]).astype(np.int64)[..., ENC_ZIGZAG]
        h, v = factors[i]
        blocks.append(q.reshape(mcuy, v, mcux, h, 64).transpose(0, 2, 1, 3, 4).reshape(mcuy * mcux, h * v, 64))
    mcu = np.concatenate(blocks, axis=1)  # (MCUs, blocks per MCU, 64) in scan order
    comp = np.array([i for i, (h, v) in enumerate(factors) for _ in range(h * v)])
    tables = [((_codes(*HUFFMAN[0, t])), _codes(*HUFFMAN[1, t])) for t in range(2)]
    per = restart_interval or len(mcu)
    segs = [_entropy(mcu[s:s + per].reshape(-1, 64), np.tile(comp, len(mcu[s:s + per])), tables)
            for s in range(0, len(mcu), per)]
    scan = b"".join(seg + (bytes([0xFF, 0xD0 + i % 8]) if i < len(segs) - 1 else b"")
                    for i, seg in enumerate(segs))

    def segment(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    sof = struct.pack(">BHHB", 8, H, W, C) + b"".join(
        bytes([i + 1, h << 4 | v, TABLE_OF[i]]) for i, (h, v) in enumerate(factors))
    sos = bytes([C]) + b"".join(bytes([i + 1, TABLE_OF[i] * 0x11]) for i in range(C))
    dqt = b"".join(bytes([t]) + qts[t][ENC_ZIGZAG].astype(np.uint8).tobytes() for t in range(1 if grey else 2))
    dht = b"".join(bytes([c << 4 | t]) + bytes(HUFFMAN[c, t][0]) + bytes(HUFFMAN[c, t][1])
                   for c in range(2) for t in range(1 if grey else 2))
    if raw:
        app = b""
    elif C == 4:
        app = segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe)) if adobe is not None else b""
    else:
        app = segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out = (b"\xff\xd8" + app
           + segment(0xDB, dqt) + segment(0xC0, sof) + segment(0xC4, dht)
           + (segment(0xDD, struct.pack(">H", restart_interval)) if restart_interval else b"")
           + segment(0xDA, sos + bytes([0, 63, 0])) + scan + b"\xff\xd9")
    return out



# ---- TIFF and BMP writers, for the CLI phase's dataset and decode times ----
# The port writes neither (the JAX package writes neither); the files are
# built from the formats' specifications, as tests/torch_image_writers.py
# builds its own.

def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW as libtiff's LZWEncode writes it: a Clear first, 9 to
    12-bit codes most significant bit first, the width grown when the next
    entry would not fit, a Clear when the table reaches 4094 entries."""
    codes, widths = [256], [9]
    nbits, free, table = 9, 258, {}

    def grow():
        nonlocal nbits, free, table
        free += 1
        if free == 4094:
            codes.append(256), widths.append(nbits)
            nbits, free, table = 9, 258, {}
        elif free > (1 << nbits) - 1:
            nbits += 1

    w = data[0]
    for b in data[1:]:
        c = table.get((w << 8) | b)
        if c is not None:
            w = c
            continue
        codes.append(w), widths.append(nbits)
        table[(w << 8) | b] = free
        grow()
        w = b
    codes.append(w), widths.append(nbits)
    grow()
    codes.append(257), widths.append(nbits)
    c, wd = np.asarray(codes, np.int64), np.asarray(widths)
    bits = (c[:, None] >> (11 - np.arange(12))) & 1
    return np.packbits(bits[np.arange(12)[None, :] >= 12 - wd[:, None]].astype(np.uint8)).tobytes()


def packbits_encode(data: bytes) -> bytes:
    """PackBits: runs of 2 to 128 equal bytes, literals of up to 128."""
    a = np.frombuffer(data, np.uint8)
    starts = np.flatnonzero(np.concatenate([[True], a[1:] != a[:-1]]))
    ends = np.concatenate([starts[1:], [len(a)]])
    out, literal = bytearray(), bytearray()

    def flush():
        for i in range(0, len(literal), 128):
            out.extend(bytes([len(literal[i:i + 128]) - 1]) + literal[i:i + 128])
        literal.clear()

    for s, e in zip(starts.tolist(), ends.tolist()):
        if e - s == 1:
            literal.append(int(a[s]))
            continue
        flush()
        for i in range(s, e, 128):
            n = min(128, e - i)
            out.extend(bytes([257 - n, int(a[s])]) if n > 1 else bytes([0, int(a[s])]))
    flush()
    return bytes(out)


def tiff_form(rgb, depth, compression=1, predictor=None, rows_per_strip=16, planar=False, big=False) -> bytes:
    """A little-endian RGB TIFF of (H, W, 3) samples, or RGBA of (H, W, 4)
    (ExtraSamples 2: unassociated alpha), at 8 or 16 bits, in strips of
    `rows_per_strip` rows: uncompressed (1), LZW (5), deflate (8), PackBits
    (32773) or LZMA (34925: an .xz stream a strip, as libtiff's LZMA codec
    writes), with Predictor 2 (each sample less its left neighbour's, in
    its own unsigned type) where asked; `planar`: each sample's strips in
    turn (PlanarConfiguration 2); `big`: a BigTIFF."""
    H, W, n = rgb.shape
    dt = "<u2" if depth == 16 else "u1"
    planes = [rgb[..., i:i + 1] for i in range(n)] if planar else [rgb]
    bodies = []
    for plane in planes:
        for y in range(0, H, rows_per_strip):
            strip = plane[y:y + rows_per_strip].astype(dt)
            if predictor == 2:
                strip = np.concatenate([strip[:, :1], strip[:, 1:] - strip[:, :-1]], axis=1)
            raw = strip.tobytes()
            bodies.append({1: lambda b: b, 5: lzw_encode, 8: lambda b: zlib.compress(b, 6), 32773: packbits_encode,
                           34925: lambda b: lzma.compress(b, lzma.FORMAT_XZ, lzma.CHECK_NONE)}[compression](raw))
    offsets = 16 if big else 4  # LONG8 in a BigTIFF
    tags = [(256, 4, [W]), (257, 4, [H]), (258, 3, [depth] * n), (259, 3, [compression]), (262, 3, [2]),
            (273, offsets, [0] * len(bodies)), (277, 3, [n]), (278, 3, [rows_per_strip]),
            (279, 4, [len(b) for b in bodies])] + ([(284, 3, [2])] if planar else []) + (
        [(317, 3, [predictor])] if predictor else []) + ([(338, 3, [2])] if n == 4 else [])
    return tiff_file(tags, bodies, big)


def rle8_encode(indices) -> bytes:
    """BMP RLE8 of (H, W) palette indices, bottom row first: runs of 3 to
    255 equal indices in encoded mode, the rest in absolute runs of 3 to
    254 (word-padded) or encoded runs of one, end of line after each row,
    end of bitmap last."""
    out = bytearray()
    for row in indices[::-1]:
        starts = np.flatnonzero(np.concatenate([[True], row[1:] != row[:-1]]))
        ends = np.concatenate([starts[1:], [len(row)]])
        literal = []

        def flush():
            for i in range(0, len(literal), 254):
                part = literal[i:i + 254]
                if len(part) >= 3:
                    out.extend(bytes([0, len(part)]) + bytes(part) + b"\0" * (len(part) % 2))
                else:
                    out.extend(b"".join(bytes([1, v]) for v in part))
            literal.clear()

        for s, e in zip(starts.tolist(), ends.tolist()):
            if e - s < 3:
                literal.extend([int(row[s])] * (e - s))
                continue
            flush()
            for i in range(s, e, 255):
                out.extend(bytes([min(255, e - i), int(row[s])]))
        flush()
        out.extend(b"\0\0")
    return bytes(out + b"\0\1")


def bmp_form(body: bytes, W, H, bits, compression=0, palette=None, masks=None) -> bytes:
    """A BMP: BITMAPINFOHEADER, or a V5 header carrying `masks` (r, g, b,
    a) for BI_BITFIELDS; a palette of (N, 3) RGB entries; `body` the pixel
    data as stored (rows bottom-up, padded to 4 bytes, unless RLE)."""
    size = 40 if masks is None else 124
    header = struct.pack("<IiiHHIIiiII", size, W, H, 1, bits, compression, len(body), 2835, 2835,
                         0 if palette is None else len(palette), 0)
    if masks is not None:
        header = (header + struct.pack("<4I", *masks)).ljust(size, b"\0")
    table = b"" if palette is None else np.concatenate(
        [np.asarray(palette, np.uint8)[:, ::-1], np.zeros((len(palette), 1), np.uint8)], 1).tobytes()
    offset = 14 + len(header) + len(table)
    return b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset) + header + table + body


def bmp_rows(row_bytes) -> bytes:
    """(H, n) row bytes as a BMP stores them: bottom-up, padded to 4."""
    H, n = row_bytes.shape
    out = np.zeros((H, -(-n // 4) * 4), np.uint8)
    out[:, :n] = row_bytes
    return out[::-1].tobytes()


# ---- WebP and GIF writers, for the CLI and Blender phases ----
# The port writes neither (the JAX package writes neither): each is the
# plainest file of its format, built from the specification.

REVERSED_BYTE = np.array([int(f"{v:08b}"[::-1], 2) for v in range(256)], np.uint8)


def vp8l_form(rgb) -> bytes:
    """A lossless WebP (RIFF, one VP8L chunk) of (H, W, 3) uint8 pixels: no
    transform, no colour cache, no meta prefix codes; the green (with its
    24 length codes unused), red, blue and alpha prefix codes give each of
    the 256 byte values length 8, so a value's code is the value itself; the
    distance code has one symbol. Every pixel is four 8-bit literals (alpha
    255, the header's alpha bit clear: PIL reads mode RGB)."""
    H, W = rgb.shape[:2]
    head = []  # (value, bits), least significant bit first

    def put(value, n):
        head.extend((value >> i) & 1 for i in range(n))

    put(0x2F, 8), put(W - 1, 14), put(H - 1, 14), put(0, 1), put(0, 3)
    put(0, 1), put(0, 1), put(0, 1)  # no transform, no colour cache, no meta prefix codes
    for alphabet in (280, 256, 256, 256):
        put(0, 1), put(12 - 4, 4)  # a normal code; 12 code-length code lengths, in RFC 9649's order:
        for symbol in (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8):  # lengths 0 and 8, one bit each
            put(1 if symbol in (0, 8) else 0, 3)
        put(0, 1)  # a length for every symbol: 8 (code 1) for the bytes, 0 (code 0) past them
        head.extend([1] * 256 + [0] * (alphabet - 256))
    put(1, 1), put(0, 1), put(0, 1), put(0, 1)  # distance: a simple code of the one symbol 0
    px = np.concatenate([rgb[..., 1:2], rgb[..., :1], rgb[..., 2:3], np.full((H, W, 1), 255, np.uint8)], -1)
    # a code is read most significant bit first from a stream packed least significant bit first
    pixel_bits = np.unpackbits(REVERSED_BYTE[px].reshape(-1), bitorder="little")
    body = np.packbits(np.concatenate([np.array(head, np.uint8), pixel_bits]), bitorder="little").tobytes()
    chunk = b"VP8L" + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk


def gif_form(indices, palette, transparency=None, interlace=False) -> bytes:
    """A GIF89a of (H, W) indices into `palette` ((2^k, 3) uint8, k >= 1): a
    global palette, a graphic-control extension with the transparency index
    if one is given, one frame (its rows in the four interlaced passes if
    `interlace`). LZW at minimum code size 8 with only literal codes: a
    Clear before every 254 indices keeps the decoder's table below 512
    entries, so every code is 9 bits."""
    H, W = indices.shape
    rows = np.concatenate([np.arange(s, H, step) for s, step in ((0, 8), (4, 8), (2, 4), (1, 2))]) \
        if interlace else np.arange(H)
    flat = indices[rows].reshape(-1).astype(np.int64)
    runs = np.arange(0, len(flat), 254)
    codes = np.concatenate([np.insert(flat, runs, 256), [257]])  # Clear before each run, End last
    data = np.packbits(((codes[:, None] >> np.arange(9)) & 1).astype(np.uint8).reshape(-1),
                       bitorder="little")
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255].tobytes() for i in range(0, len(data), 255))
    n = len(palette)
    out = b"GIF89a" + struct.pack("<HHBBB", W, H, 0x80 | (n.bit_length() - 2), 0, 0)
    out += np.asarray(palette, np.uint8).tobytes()
    if transparency is not None:
        out += b"!\xf9\x04\x01\x00\x00" + bytes([transparency]) + b"\x00"
    out += b"," + struct.pack("<HHHHB", 0, 0, W, H, 0x40 if interlace else 0)
    return out + b"\x08" + blocks + b"\x00;"


def cmyk_of(rgb):
    """PIL-convention CMYK (H, W, 4) uint8 whose cmyk2rgb is close to `rgb`
    (K from the brightest channel), and the samples a CMYK JPEG stores for
    them (PIL reads them inverted)."""
    top = rgb.max(axis=-1, keepdims=True).astype(np.int64)
    cmy = 255 - (rgb.astype(np.int64) * 255 + top // 2) // np.maximum(top, 1)
    pil = np.concatenate([np.where(top > 0, cmy, 0), 255 - top], -1).astype(np.uint8)
    return pil, 255 - pil


def cmyk_to_rgba(cmyk):
    """PIL's cmyk2rgb: each colour (255 - k) - c (255 - k) / 255, PIL's
    rounded division; alpha 255."""
    nk = 255 - cmyk[..., 3:].astype(np.int64)
    t = cmyk[..., :3].astype(np.int64) * nk + 128
    rgb = nk - (((t >> 8) + t) >> 8)
    return np.concatenate([rgb, np.full_like(nk, 255)], -1).astype(np.uint8)

# ---- PPM, TGA and JPEG-in-TIFF writers, for the CLI phases' datasets and decode times ----
# The port writes none of them (the JAX package writes none), so the files
# are built from the formats' specifications, as
# tests/torch_image_writers.py builds its own.

_DIGITS = np.zeros((65536, 6), np.uint8)  # each value's decimal digits, right-aligned, and a space
_DIGITS_USED = np.zeros((65536, 6), bool)
for _v in range(65536):
    _t = b"%d " % _v
    _DIGITS[_v, 6 - len(_t):] = np.frombuffer(_t, np.uint8)
    _DIGITS_USED[_v, 6 - len(_t):] = True


def ppm_form(magic: bytes, samples, maxval=255, plain=False) -> bytes:
    """A PGM / PPM of (H, W, C) integer samples (binary: one byte a sample
    at maxval < 256, else two big-endian; `plain`: decimal samples, a line
    a row) or a grey PFM of (H, W) floats (Pf: rows bottom to top, little
    endian, scale -1)."""
    a = np.asarray(samples)
    H, W = a.shape[:2]
    head = magic + b"\n%d %d\n" % (W, H)
    if magic == b"Pf":
        return head + b"-1.0\n" + np.ascontiguousarray(a[::-1]).astype("<f4").tobytes()
    head += b"%d\n" % maxval
    if not plain:
        return head + np.ascontiguousarray(a).astype(np.uint8 if maxval < 256 else ">u2").tobytes()
    flat = a.reshape(H, -1).astype(np.int64)
    text = _DIGITS[flat].copy()
    text[:, -1, -1] = ord("\n")  # each row's last sample ends its line
    return head + text[_DIGITS_USED[flat]].tobytes()


def tga_rle_encode(px) -> bytes:
    """TGA RLE of (H, W, C) pixels in file order: runs of 2 to 128 equal
    pixels within a row as run packets, the other pixels in raw packets of
    up to 128, which run on across rows (as PIL's reader takes them)."""
    H, W, C = px.shape
    flat = np.ascontiguousarray(px).reshape(H * W, C)
    key = flat.astype(np.int64) @ (256 ** np.arange(C))
    same = np.zeros(H * W, bool)
    same[:-1] = key[1:] == key[:-1]
    same[W - 1::W] = False  # runs end with their row
    starts = np.flatnonzero(np.concatenate([[True], ~same[:-1]]))
    lengths = np.diff(np.append(starts, H * W))
    pieces = -(-lengths // 128)  # runs cut into pieces of at most 128
    first = np.repeat(np.cumsum(pieces) - pieces, pieces)
    p_start = np.repeat(starts, pieces) + 128 * (np.arange(pieces.sum()) - first)
    p_len = np.minimum(128, np.repeat(starts + lengths, pieces) - p_start)
    single = p_len == 1
    # single pixels gather into raw packets of up to 128 consecutive ones
    begin = single & ~np.concatenate([[False], single[:-1]])
    since = np.arange(len(single)) - np.maximum.accumulate(np.where(begin, np.arange(len(single)), 0))
    opens = ~single | (single & (since % 128 == 0))
    packet = np.cumsum(opens) - 1
    n_packets = packet[-1] + 1
    count = np.bincount(packet, weights=np.where(single, 1, 0), minlength=n_packets).astype(np.int64)
    is_run = np.zeros(n_packets, bool)
    is_run[packet[~single]] = True
    run_len = np.zeros(n_packets, np.int64)
    run_len[packet[~single]] = p_len[~single]
    size = 1 + np.where(is_run, C, C * count)
    at = np.concatenate([[0], np.cumsum(size)[:-1]])
    out = np.zeros(int(size.sum()), np.uint8)
    out[at] = np.where(is_run, 0x80 | (run_len - 1), count - 1)
    runs = np.flatnonzero(~single)
    out[(at[packet[runs]] + 1)[:, None] + np.arange(C)] = flat[p_start[runs]]
    singles = np.flatnonzero(single)
    slot = singles - np.flatnonzero(opens)[packet[singles]]  # place within its raw packet
    out[(at[packet[singles]] + 1 + C * slot)[:, None] + np.arange(C)] = flat[p_start[singles]]
    return out.tobytes()


def tga_form(px, image_type, flags=0x20, colormap=None) -> bytes:
    """A TGA of (H, W, C) pixels (C = 1: grey or colour-map indices; 3: RGB
    as BGR; 4: RGBA as BGRA), `flags` its descriptor byte (0x20: the first
    row on top), RLE for image types 9 to 11, a 24-bit colour map ((N, 3)
    RGB) for types 1 and 9."""
    H, W, C = px.shape
    stored = px[..., [2, 1, 0, 3][:C]] if C >= 3 else px
    rows = stored if flags & 0x20 else stored[::-1]
    body = tga_rle_encode(rows) if image_type & 8 else np.ascontiguousarray(rows).tobytes()
    cmap = b"" if colormap is None else np.ascontiguousarray(np.asarray(colormap, np.uint8)[:, ::-1]).tobytes()
    head = struct.pack("<BBBHHBHHHHBB", 0, int(colormap is not None), image_type, 0, len(cmap) // 3,
                       24 if colormap is not None else 0, 0, 0, W, H, 8 * C, flags | (8 if C == 4 else 0))
    return head + cmap + body


def jpeg_tables_apart(stream: bytes):
    """(JPEGTables, abbreviated stream) of one baseline JPEG: its DQT and DHT
    segments between SOI and EOI, and the stream without them, as libtiff
    writes a JPEG-in-TIFF's tag and strips."""
    pos, tables, rest = 2, [], []
    while stream[pos + 1] != 0xDA:
        n = struct.unpack(">H", stream[pos + 2:pos + 4])[0]
        (tables if stream[pos + 1] in (0xDB, 0xC4) else rest).append(stream[pos:pos + 2 + n])
        pos += 2 + n
    return b"\xff\xd8" + b"".join(tables) + b"\xff\xd9", b"\xff\xd8" + b"".join(rest) + stream[pos:]


def jpeg_tiff_form(rgb, quality, rows_per_strip=16, tile=None):
    """A little-endian RGB JPEG-in-TIFF (compression 7, photometric RGB) of
    (H, W, 3) pixels: each strip of `rows_per_strip` rows, or each `tile` =
    (width, height) (edge-padded where it overhangs), coded by
    `encode_jpeg(raw=True)` as an abbreviated stream, the tables in the
    JPEGTables tag. Returns the file and, per strip or tile, the standalone
    JPEG it is (its tables put back, an Adobe marker of transform 0: RGB as
    stored), for the regular decoder to read."""
    H, W, _ = rgb.shape
    if tile:
        tw, th = tile
        across, down = -(-W // tw), -(-H // th)
        padded = np.pad(rgb, ((0, down * th - H), (0, across * tw - W), (0, 0)), mode="edge")
        chunks = [padded[r * th:(r + 1) * th, c * tw:(c + 1) * tw] for r in range(down) for c in range(across)]
    else:
        chunks = [rgb[y:y + rows_per_strip] for y in range(0, H, rows_per_strip)]
    bodies, whole, tables = [], [], b""
    adobe = b"\xff\xee\x00\x0eAdobe" + struct.pack(">HHHB", 100, 0, 0, 0)
    for chunk in chunks:
        tables, body = jpeg_tables_apart(encode_jpeg(chunk, quality, raw=True))
        bodies.append(body)
        whole.append(b"\xff\xd8" + adobe + tables[2:-2] + body[2:])
    tags = [(256, 4, [W]), (257, 4, [H]), (258, 3, [8] * 3), (259, 3, [7]), (262, 3, [2]), (277, 3, [3])]
    if tile:
        tags += [(322, 3, [tile[0]]), (323, 3, [tile[1]]), (324, 4, [0] * len(bodies)),
                 (325, 4, [len(b) for b in bodies])]
    else:
        tags += [(273, 4, [0] * len(bodies)), (278, 3, [rows_per_strip]), (279, 4, [len(b) for b in bodies])]
    tags += [(347, 7, list(tables))]
    return tiff_file(tags, bodies), whole


def tiff_file(tags, bodies, big=False) -> bytes:
    """A little-endian TIFF of `tags` ((tag, type, values), sorted; 3 SHORT,
    4 LONG, 7 UNDEFINED, 16 LONG8) and the strips or tiles `bodies` after
    them, the offsets tag (273 or 324) filled in; `big`: a BigTIFF (8-byte
    counts and offsets, 20-byte entries)."""
    size, code = {3: 2, 4: 4, 7: 1, 16: 8}, {3: "H", 4: "I", 7: "B", 16: "Q"}
    entry, inline, word = (20, 8, "Q") if big else (12, 4, "I")
    head = 16 if big else 8
    data_at = head + (8 if big else 2) + entry * len(tags) + inline
    blobs, entries = b"", []
    strips_at = data_at + sum(-(-len(v) * size[t] // 2) * 2 for _, t, v in tags if len(v) * size[t] > inline)
    offsets = np.concatenate([[0], np.cumsum([len(b) for b in bodies])[:-1]]) + strips_at
    for tag, typ, vals in tags:
        vals = offsets.tolist() if tag in (273, 324) else vals
        raw = struct.pack("<" + code[typ] * len(vals), *vals)
        if len(raw) <= inline:
            entries.append(struct.pack("<HH" + word, tag, typ, len(vals)) + raw.ljust(inline, b"\0"))
        else:
            entries.append(struct.pack("<HH" + word + word, tag, typ, len(vals), data_at + len(blobs)))
            blobs += raw + b"\0" * (len(raw) % 2)
    start = (b"II+\0" + struct.pack("<HHQQ", 8, 0, head, len(tags))) if big else (
        b"II*\0" + struct.pack("<IH", head, len(tags)))
    return start + b"".join(entries) + struct.pack("<" + word, 0) + blobs + b"".join(bodies)


def ycbcr_tiff_form(rgb, quality, rows_per_strip=16, sampling=(2, 2)):
    """A little-endian JPEG-in-TIFF in YCbCr (compression 7, photometric 6,
    GDAL's PHOTOMETRIC=YCBCR) of (H, W, 3) pixels: each strip of
    `rows_per_strip` rows `encode_jpeg`'s YCbCr stream with the chroma
    subsampled `sampling`, abbreviated (its tables in the JPEGTables tag),
    the YCbCrSubsampling tag `sampling`. Returns the file and, per strip,
    the standalone JPEG (JFIF, YCbCr) it is, for the regular decoder."""
    H, W, _ = rgb.shape
    bodies, whole, tables = [], [], b""
    for y in range(0, H, rows_per_strip):
        whole.append(encode_jpeg(rgb[y:y + rows_per_strip], quality, sampling))
        tables, body = jpeg_tables_apart(whole[-1])
        bodies.append(body)
    tags = [(256, 4, [W]), (257, 4, [H]), (258, 3, [8] * 3), (259, 3, [7]), (262, 3, [6]),
            (273, 4, [0] * len(bodies)), (277, 3, [3]), (278, 3, [rows_per_strip]),
            (279, 4, [len(b) for b in bodies]), (347, 7, list(tables)), (530, 3, list(sampling))]
    return tiff_file(tags, bodies), whole


def form_picture(h=H_MAIN, w=W_MAIN, seed=15):
    """(h, w, 3) uint8 made with integers only, the same on every machine:
    a seeded grid of colours every 40 pixels, bilinearly blended."""
    rng = np.random.default_rng(seed)
    grid = rng.integers(0, 256, (h // 40 + 2, w // 40 + 2, 3), dtype=np.int64)
    yy, xx = np.mgrid[0:h, 0:w]
    y0, x0, fy, fx = yy // 40, xx // 40, (yy % 40)[..., None], (xx % 40)[..., None]
    blend = (grid[y0, x0] * (40 - fy) * (40 - fx) + grid[y0 + 1, x0] * fy * (40 - fx)
             + grid[y0, x0 + 1] * (40 - fy) * fx + grid[y0 + 1, x0 + 1] * fy * fx)
    return (blend // 1600).astype(np.uint8)


def form_files():
    """The 1080p TIFFs in the GIS and orthophoto forms this script writes
    itself (tests/fixtures/torch_tiff_forms/sha256.json holds PIL's reading
    of each and, for the lossy one, the file's SHA-256): YCbCr
    JPEG-in-TIFF, planar LZMA in a BigTIFF, 16-bit planar deflate with
    Predictor 2, a BigTIFF of deflate strips."""
    px = form_picture()
    return {
        "chip_smoke: YCbCr JPEG-in-TIFF 4:2:0 q90, strips of 16": ycbcr_tiff_form(px, 90, 16, (2, 2))[0],
        "chip_smoke: planar LZMA BigTIFF, strips of 64": tiff_form(px, 8, 34925, None, 64, planar=True, big=True),
        "chip_smoke: planar deflate 16-bit + predictor": tiff_form(wide_samples(px), 16, 8, 2, 32, planar=True),
        "chip_smoke: BigTIFF deflate + predictor": tiff_form(px, 8, 8, 2, 16, big=True),
    }


# The TIFF forms of fax archives, scanners, old JPEG-in-TIFF writers and
# scientific pipelines: the committed PIL-written 1080p Group 4 and Group 3
# 2-D files of the bilevel picture, and the forms this script writes itself
# (`rest_form_files`); tests/fixtures/torch_tiff_rest/sha256.json holds
# PIL's reading of each, and of the small files committed there.
TIFF_REST_FIXTURES = os.path.join(FIXTURES, "torch_tiff_rest")
REST_G4, REST_G3 = "bilevel_g4_1920x1080.tif", "bilevel_g3_2d_1920x1080.tif"
# view 15 of phase 5c: a YCbCr TIFF (LZW, 4:2:0 data units) of this script's writer
CLI_YCBCR_UNITS_VIEW = 15
YCBCR_ROWS = 16


def bilevel_picture(px=None):
    """The 1080p bilevel picture of the fax files: the form picture's luma
    (integer weights) over 128."""
    px = form_picture() if px is None else px
    return ((px.astype(np.int64) * [299, 587, 114]).sum(-1) // 1000) > 128


def rgb_to_ycbcr(px):
    """(H, W, 3) uint8 Y, Cb, Cr of RGB pixels in BT.601 integer weights."""
    r, g, b = (px[..., i].astype(np.int64) for i in range(3))
    y = (77 * r + 150 * g + 29 * b + 128) >> 8
    cb = ((-43 * r - 85 * g + 128 * b + 128) >> 8) + 128
    cr = ((128 * r - 107 * g - 21 * b + 128) >> 8) + 128
    return np.clip(np.stack([y, cb, cr], -1), 0, 255).astype(np.uint8)


def ycbcr_units(ycc, h, v):
    """(unit rows, bytes) of TIFF's YCbCr data units of (rows, W, 3) Y, Cb,
    Cr subsampled h x v: each unit its h * v luma samples row by row, then
    the mean Cb and Cr of its samples (edges repeated into partial units)."""
    rows, width = ycc.shape[:2]
    uh, uw = -(-rows // v), -(-width // h)
    p = np.pad(ycc.astype(np.int64), ((0, uh * v - rows), (0, uw * h - width), (0, 0)), mode="edge")
    blocks = p.reshape(uh, v, uw, h, 3).transpose(0, 2, 1, 3, 4).reshape(uh, uw, h * v, 3)
    chroma = (blocks[..., 1:].sum(2) + h * v // 2) // (h * v)
    return np.concatenate([blocks[..., 0], chroma], -1).astype(np.uint8).reshape(uh, -1)


def ycbcr_strips(px, sampling=(2, 2), rows_per_strip=YCBCR_ROWS):
    """Each strip's data units of RGB pixels (`ycbcr_units`), and (H, W, 3)
    Y, Cb, Cr as each pixel's unit holds them."""
    H, W, _ = px.shape
    h, v = sampling
    ycc = rgb_to_ycbcr(px)
    strips, held = [], []
    for y in range(0, H, rows_per_strip):
        units = ycbcr_units(ycc[y:y + rows_per_strip], h, v)
        strips.append(units.tobytes())
        u = units.reshape(len(units), -1, h * v + 2)
        luma = u[..., :h * v].reshape(len(u), -1, v, h).transpose(0, 2, 1, 3).reshape(len(u) * v, -1)
        chroma = np.repeat(np.repeat(u[..., h * v:], v, 0), h, 1)
        held.append(np.concatenate([luma[..., None], chroma], -1)[:min(rows_per_strip, H - y), :W])
    return strips, np.concatenate(held)


def ycbcr_units_form(px, compression, sampling=(2, 2), rows_per_strip=YCBCR_ROWS) -> bytes:
    """A little-endian YCbCr TIFF (photometric 6, not JPEG) of RGB pixels:
    strips of TIFF's data units (`ycbcr_strips`), LZW (5) or deflate (8)."""
    H, W, _ = px.shape
    strips, _ = ycbcr_strips(px, sampling, rows_per_strip)
    bodies = [{5: lzw_encode, 8: lambda b: zlib.compress(b, 6)}[compression](b) for b in strips]
    tags = [(256, 4, [W]), (257, 4, [H]), (258, 3, [8] * 3), (259, 3, [compression]), (262, 3, [6]),
            (273, 4, [0] * len(bodies)), (277, 3, [3]), (278, 3, [rows_per_strip]),
            (279, 4, [len(b) for b in bodies]), (530, 3, list(sampling))]
    return tiff_file(tags, bodies)


def tiff_ycbcr_to_rgb(ycc):
    """RGB of Y, Cb, Cr samples as libtiff's TIFFYCbCrToRGBInit /
    TIFFYCbCrtoRGB give it at the tags' defaults (coefficients 0.299, 0.587,
    0.114, reference black and white 0 255 128 255 128 255): 16-bit fixed
    point from single-precision factors, clamped."""
    f32 = np.float32
    lr, lg, lb = f32(0.299), f32(0.587), f32(0.114)
    fix = lambda x: int(np.float64(x) * 65536 + 0.5)
    f1, f3 = f32(2) - f32(2) * lr, f32(2) - f32(2) * lb
    d1, d2 = fix(f1), -fix(f32(lr * f1) / lg)
    d3, d4 = fix(f3), -fix(f32(lb * f3) / lg)
    x = np.arange(-128, 128)
    c = np.trunc((x.astype(f32) * f32(127)) / f32(127)).astype(np.int64)  # Code2V at the default range
    yt = np.trunc((np.arange(256).astype(f32) * f32(255)) / f32(255)).astype(np.int64)
    y, cb, cr = (ycc[..., i].astype(np.int64) for i in range(3))
    r = yt[y] + ((d1 * c[cr] + 32768) >> 16)
    g = yt[y] + ((d4 * c[cb] + 32768 + d2 * c[cr]) >> 16)
    b = yt[y] + ((d3 * c[cb] + 32768) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def float_p3_form(values, rows_per_strip=16):
    """A little-endian float32 grey TIFF (SampleFormat 3), deflate with
    Predictor 3: each row's samples split into byte planes, most significant
    first, each byte less the one before it (libtiff's fpDiff)."""
    H, W = values.shape
    bodies = []
    for y in range(0, H, rows_per_strip):
        raw = values[y:y + rows_per_strip].astype("<f4").view(np.uint8).reshape(-1, W, 4)
        planes = raw[:, :, ::-1].transpose(0, 2, 1).reshape(len(raw), -1)
        diff = np.concatenate([planes[:, :1], planes[:, 1:] - planes[:, :-1]], 1)
        bodies.append(zlib.compress(diff.tobytes(), 6))
    tags = [(256, 4, [W]), (257, 4, [H]), (258, 3, [32]), (259, 3, [8]), (262, 3, [1]),
            (273, 4, [0] * len(bodies)), (277, 3, [1]), (278, 3, [rows_per_strip]),
            (279, 4, [len(b) for b in bodies]), (317, 3, [3]), (339, 3, [3])]
    return tiff_file(tags, bodies)


def lab_form(samples, rows_per_strip=16):
    """A little-endian 8-bit CIELab TIFF (photometric 8) of (H, W, 3)
    samples, LZW."""
    H, W, _ = samples.shape
    bodies = [lzw_encode(samples[y:y + rows_per_strip].tobytes()) for y in range(0, H, rows_per_strip)]
    tags = [(256, 4, [W]), (257, 4, [H]), (258, 3, [8] * 3), (259, 3, [5]), (262, 3, [8]),
            (273, 4, [0] * len(bodies)), (277, 3, [3]), (278, 3, [rows_per_strip]),
            (279, 4, [len(b) for b in bodies])]
    return tiff_file(tags, bodies)


def thunderscan_rows(rows) -> bytes:
    """ThunderScan (compression 32809) of (rows, W) 4-bit samples, each row
    on its own: a run of the last pixel (up to 63), three 2-bit or two
    3-bit deltas where they fit, else a raw pixel."""
    two = {0: 0, 1: 1, -1: 3}
    three = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}
    out = bytearray()
    for row in rows.tolist():
        w, x, last = len(row), 0, 0
        while x < w:
            run = 0
            while x + run < w and run < 63 and row[x + run] == last:
                run += 1
            if run >= 2:
                out.append(run)
                x += run
                continue
            d = [v - p for p, v in zip([last] + row[x:x + 2], row[x:x + 3])]
            if x + 3 <= w and all(k in two for k in d):
                out.append(0x40 | two[d[0]] << 4 | two[d[1]] << 2 | two[d[2]])
                x, last = x + 3, row[x + 2]
            elif x + 2 <= w and all(k in three for k in d[:2]):
                out.append(0x80 | three[d[0]] << 3 | three[d[1]])
                x, last = x + 2, row[x + 1]
            else:
                out.append(0xC0 | row[x])
                x, last = x + 1, row[x]
    return bytes(out)


def thunderscan_form(grey4, rows_per_strip=16):
    H, W = grey4.shape
    bodies = [thunderscan_rows(grey4[y:y + rows_per_strip]) for y in range(0, H, rows_per_strip)]
    tags = [(256, 4, [W]), (257, 4, [H]), (258, 3, [4]), (259, 3, [32809]), (262, 3, [1]),
            (273, 4, [0] * len(bodies)), (277, 3, [1]), (278, 3, [rows_per_strip]),
            (279, 4, [len(b) for b in bodies])]
    return tiff_file(tags, bodies)


def ojpeg_form(rgb, quality, rows_per_strip=16):
    """An old-style JPEG-in-TIFF (compression 6) of RGB pixels with its
    tables in tags: `encode_jpeg`'s 4:2:0 YCbCr stream with a restart
    marker every strip, each restart interval one strip's bytes (libtiff
    puts the markers back), JPEGProc 1, JPEGQTables / JPEGDCTables /
    JPEGACTables one table each a component (appended after the strips),
    JPEGRestartInterval, YCbCrSubsampling 2x2."""
    H, W, _ = rgb.shape
    mcus = -(-W // 16) * (rows_per_strip // 16)
    stream = encode_jpeg(rgb, quality, (2, 2), mcus)
    pos, qt, huff = 2, {}, {}
    while stream[pos + 1] != 0xDA:
        marker, n = stream[pos + 1], struct.unpack(">H", stream[pos + 2:pos + 4])[0]
        body, at = stream[pos + 4:pos + 2 + n], 0
        while marker in (0xDB, 0xC4) and at < len(body):
            if marker == 0xDB:
                qt[body[at] & 15], at = body[at + 1:at + 65], at + 65
            else:
                k = 17 + sum(body[at + 1:at + 17])
                huff[body[at]], at = body[at + 1:at + k], at + k
        pos += 2 + n
    n = struct.unpack(">H", stream[pos + 2:pos + 4])[0]
    sos = stream[pos + 4:pos + 2 + n]
    scan = [sos[2 + 2 * i] for i in range(sos[0])]  # each component's (DC << 4 | AC) tables
    data = stream[pos + 2 + n:stream.rindex(b"\xff\xd9")]
    bodies = []
    at = 0
    for k in range(-(-H // rows_per_strip)):
        end = data.find(bytes([0xFF, 0xD0 + k % 8]), at) if k < -(-H // rows_per_strip) - 1 else len(data)
        bodies.append(data[at:end])
        at = end + 2
    blobs = [qt[0], qt[1], qt[1]] + [huff[t >> 4] for t in scan] + [huff[16 | (t & 15)] for t in scan]
    tags = lambda offsets: [  # noqa: E731
        (256, 4, [W]), (257, 4, [H]), (258, 3, [8] * 3), (259, 3, [6]), (262, 3, [6]),
        (273, 4, [0] * len(bodies)), (277, 3, [3]), (278, 3, [rows_per_strip]),
        (279, 4, [len(b) for b in bodies]), (512, 3, [1]), (515, 3, [mcus]), (519, 4, offsets[:3]),
        (520, 4, offsets[3:6]), (521, 4, offsets[6:]), (530, 3, [2, 2])]
    end = len(tiff_file(tags([0] * 9), bodies))
    offsets = (end + np.concatenate([[0], np.cumsum([len(b) for b in blobs])[:-1]])).tolist()
    return tiff_file(tags(offsets), bodies) + b"".join(blobs)


def rest_form_files():
    """The 1080p files in the forms of fax archives, old JPEG-in-TIFF
    writers, YCbCr scanners, float and CIELab pipelines and ThunderScan this
    script writes itself, from the form picture (tests/fixtures/
    torch_tiff_rest/sha256.json holds PIL's reading of each)."""
    px = form_picture()
    lum = (px.astype(np.int64) * [299, 587, 114]).sum(-1) // 1000
    return {
        "chip_smoke: old-style JPEG, tables in tags, 4:2:0 q90, strips of 16": ojpeg_form(px, 90),
        "chip_smoke: YCbCr deflate 4:2:0, strips of 16": ycbcr_units_form(px, 8),
        "chip_smoke: float32 grey deflate + predictor 3": float_p3_form((lum.astype(np.float32) - 127.5) / 64),
        "chip_smoke: CIELab LZW": lab_form(px),
        "chip_smoke: ThunderScan 4-bit": thunderscan_form((lum >> 4).astype(np.int64)),
    }


class PanelTimer:
    """Host time of tensorboard's `SummaryWriter.add_images` while patched
    (`with`), where tensorboard imports: the train CLI's reports log their
    views as image panels, as the reference's training_report does."""

    def __init__(self):
        self.ms = []

    def __enter__(self):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self.owner = None
            return self
        self.owner, self.fn = SummaryWriter, SummaryWriter.add_images

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return self.fn(*args, **kw)
            finally:
                self.ms.append((time.perf_counter() - t0) * 1e3)
        SummaryWriter.add_images = timed
        return self

    def __exit__(self, *exc):
        if self.owner is not None:
            self.owner.add_images = self.fn


def wide_samples(px):
    """16-bit samples whose high bytes are `px` and whose low bytes are a
    fixed ramp, as a scanner's or a raw converter's 16-bit output."""
    H, W = px.shape[:2]
    yy, xx = np.mgrid[0:H, 0:W]
    return (px.astype(np.int64) << 8) | (((7 * xx + 13 * yy)[..., None] + 50 * np.arange(px.shape[2])) & 255)


def train_view_files(data, cams, images, test_names):
    """Rewrite the COLMAP dataset's views outside `test_names` as baseline
    JPEG (`encode_jpeg`: 4:2:0, CLI_JPEG_QUALITY; view CLI_RESTART_VIEW
    with a restart marker every MCU row), but view CLI_TIFF_VIEW as a 16-bit
    RGB TIFF (LZW, Predictor 2), CLI_BMP_VIEW as a 24-bit BMP,
    CLI_WEBP_VIEW as a lossless WebP, CLI_PPM_VIEW as a binary P6,
    CLI_TGA_VIEW as a 32-bit RLE TGA (alpha 255), CLI_JPEG_TIFF_VIEW as
    a JPEG-in-TIFF, CLI_YCBCR_VIEW as a YCbCr JPEG-in-TIFF,
    CLI_PLANAR_VIEW as a planar LZMA BigTIFF, CLI_YCBCR_UNITS_VIEW as a
    YCbCr TIFF of LZW 4:2:0 data units, CLI_JP2_VIEW as the
    committed 1080p JPEG 2000 fixture, CLI_HT_VIEW as the committed
    1080p HTJ2K codestream and CLI_PART2_VIEW as the committed 1080p Part
    2 codestream of 20-bit samples, and images.bin to name them; the test
    views stay PNG.
    Returns each view's file name and the JPEG encode ms."""
    files, encode_ms = {}, []
    for i, (cam, px) in enumerate(zip(cams, images)):
        files[cam.image_name] = f"{cam.image_name}.png"
        if cam.image_name in test_names:
            continue
        if i == CLI_TIFF_VIEW:
            name, body = f"{cam.image_name}.tif", tiff_form(wide_samples(px), 16, 5, 2)
        elif i == CLI_BMP_VIEW:
            name, body = f"{cam.image_name}.bmp", bmp_form(bmp_rows(px[..., ::-1].reshape(len(px), -1)),
                                                            px.shape[1], px.shape[0], 24)
        elif i == CLI_WEBP_VIEW:
            name, body = f"{cam.image_name}.webp", vp8l_form(px)
        elif i == CLI_PPM_VIEW:
            name, body = f"{cam.image_name}.ppm", ppm_form(b"P6", px)
        elif i == CLI_TGA_VIEW:
            name, body = f"{cam.image_name}.tga", tga_form(opaque(px), 10)
        elif i == CLI_JPEG_TIFF_VIEW:
            name = f"{cam.image_name}.tif"
            body = jpeg_tiff_form(px, CLI_JPEG_QUALITY, CLI_JPEG_TIFF_ROWS)[0]
        elif i == CLI_YCBCR_VIEW:
            name, body = f"{cam.image_name}.tif", ycbcr_tiff_form(px, CLI_JPEG_QUALITY, CLI_JPEG_TIFF_ROWS)[0]
        elif i == CLI_PLANAR_VIEW:
            name = f"{cam.image_name}.tif"
            body = tiff_form(px, 8, 34925, None, CLI_PLANAR_ROWS, planar=True, big=True)
        elif i == CLI_YCBCR_UNITS_VIEW:
            name, body = f"{cam.image_name}.tif", ycbcr_units_form(px, 5)
        elif i == CLI_JP2_VIEW:
            name = f"{cam.image_name}.jp2"
            with open(os.path.join(JP2_FIXTURES, JP2_VIEW), "rb") as f:
                body = f.read()
        elif i == CLI_HT_VIEW:
            name = f"{cam.image_name}.j2k"
            with open(os.path.join(HT_FIXTURES, HT_VIEW), "rb") as f:
                body = f.read()
        elif i == CLI_PART2_VIEW:
            name = f"{cam.image_name}.j2k"
            with open(os.path.join(PART2_FIXTURES, PART2_VIEW), "rb") as f:
                body = f.read()
        else:
            restart = -(-W_MAIN // 16) if i == CLI_RESTART_VIEW else 0  # MCUs in a row
            t0 = time.perf_counter()
            body = encode_jpeg(px, CLI_JPEG_QUALITY, (2, 2), restart)
            encode_ms.append((time.perf_counter() - t0) * 1e3)
            if i == CLI_FLIPPED_VIEW:
                body = flip_entropy_byte(body)
            elif i == CLI_EXTRANEOUS_VIEW:
                sos, dqt = body.index(b"\xff\xda"), body.index(b"\xff\xdb")
                body = body[:dqt] + b"\x00\xff\x00\x55" + body[dqt:sos] + b"\x12\x34" + body[sos:]
            name = f"{cam.image_name}.jpg"
        os.remove(os.path.join(data, "images", files[cam.image_name]))
        files[cam.image_name] = name
        with open(os.path.join(data, "images", name), "wb") as f:
            f.write(body)
    rename_views(data, files)
    return files, encode_ms


def rename_views(data, files):
    """images.bin of the COLMAP dataset in `data` names each view's file
    `files[view name]`."""
    images_bin = os.path.join(data, "sparse", "0", "images.bin")
    records = colmap.read_images_binary(images_bin)
    for rec in records.values():
        rec.name = files[os.path.splitext(rec.name)[0]]
    colmap.write_images_binary(records, images_bin)


def pil_versions() -> str:
    """PIL's version and its libtiff's on this machine (the TIFF rules the
    port follows were found against PIL 12.1.0 with libtiff 4.7.1)."""
    if importlib.util.find_spec("PIL") is None:
        return "PIL: not on this machine"
    from PIL import features

    return f"PIL {importlib.metadata.version('pillow')}, its libtiff {features.version('libtiff')}"


def pil_jp2_ms() -> str:
    """PIL's own decode of the large JPEG 2000 fixtures (OpenJPEG), median
    of 3 on the host clock, where this machine has PIL: a comparison for
    the port's decoder only (the port never imports PIL)."""
    if importlib.util.find_spec("PIL") is None:
        return "PIL's JPEG 2000 decode not measured (no PIL here)"
    from PIL import Image, features

    ms = {}
    for path in [os.path.join(JP2_FIXTURES, name) for name in JP2_LARGE] + [
            os.path.join(JP2_PART1_FIXTURES, JP2_PART1_LARGE), os.path.join(HT_FIXTURES, HT_VIEW),
            os.path.join(PART2_FIXTURES, PART2_VIEW)]:
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            with Image.open(path) as im:
                np.asarray(im)
            times.append((time.perf_counter() - t0) * 1e3)
        ms[os.path.basename(path)] = float(np.median(times))
    return (f"PIL {importlib.metadata.version('pillow')} (OpenJPEG {features.version('jpg_2000')}) decode ms "
            f"(median of 3, host clock): " + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()))


@functools.cache
def jp2_readings() -> dict:
    """PIL's reading of each tests/fixtures/torch_jp2 file (sha256.json)."""
    with open(os.path.join(JP2_FIXTURES, "sha256.json")) as f:
        return json.load(f)


@functools.cache
def jp2_part1_readings() -> dict:
    """PIL's reading of each tests/fixtures/torch_jp2_part1 file (sha256.json)."""
    with open(os.path.join(JP2_PART1_FIXTURES, "sha256.json")) as f:
        return json.load(f)


@functools.cache
def part2_readings() -> dict:
    """PIL's reading of each tests/fixtures/torch_jp2_part2 file
    (sha256.json; `raises` where PIL raises)."""
    with open(os.path.join(PART2_FIXTURES, "sha256.json")) as f:
        return json.load(f)


@functools.cache
def ht_readings() -> dict:
    """PIL's reading of each tests/fixtures/torch_htj2k file (sha256.json;
    `raises` where PIL raises)."""
    with open(os.path.join(HT_FIXTURES, "sha256.json")) as f:
        return json.load(f)


def sha256_of(pixels) -> str:
    """The SHA-256 of pixels' bytes (mode "1": as 0 / 1 bytes, as PIL's
    np.asarray holds bools in other bytes)."""
    pixels = pixels.astype(np.uint8) if pixels.dtype == bool else pixels
    return hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()


def opaque(rgb):
    """(H, W, 4): `rgb` with alpha 255."""
    return np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], -1)


def flip_entropy_byte(body: bytes) -> bytes:
    """`body` with one bit flipped in a byte of entropy-coded data at the
    middle of the file, where neither the byte nor its neighbours are 0xFF
    (so no marker or stuffing is made or unmade)."""
    b = bytearray(body)
    at = len(b) // 2
    while 0xFF in b[at - 1:at + 2] or b[at] ^ 0x08 == 0xFF:
        at += 1
    b[at] ^= 0x08
    return bytes(b)


def check_jpeg_decoders(view_path):
    """The compiled JPEG decoder against the plain one on one 1080p view,
    and against both the plain one and PIL's pixels (committed beside each
    file) on every fixture of tests/fixtures/torch_jpeg. Returns the plain
    decoder's ms on the view and {fixture: (compiled ms, plain ms)} for the
    1237x822 ones."""
    got = image_io.read_image(view_path)
    plain, plain_ms = synced_ms(jpeg.read_jpeg, view_path, True)
    if not np.array_equal(got, plain):
        fail(f"cli path: the compiled JPEG decoder differs from the plain one on {view_path} at "
             f"{int((got != plain).any(-1).sum())} pixels")
    names = sorted(f[:-4] for f in os.listdir(JPEG_FIXTURES) if f.endswith(".jpg"))
    if not names:
        fail(f"cli path: no JPEG fixtures in {JPEG_FIXTURES}")
    times = {}
    for name in names:
        with open(os.path.join(JPEG_FIXTURES, f"{name}.jpg"), "rb") as f:
            body = f.read()
        want = np.load(os.path.join(JPEG_FIXTURES, f"{name}.npz"))["pixels"]
        want = want[..., None] if want.ndim == 2 else want
        got, c_ms = synced_ms(jpeg.decode_jpeg, body, name)
        plain, p_ms = synced_ms(jpeg.decode_jpeg, body, name, True)
        if not (np.array_equal(got, plain) and np.array_equal(got, want)):
            fail(f"cli path: fixture {name}: compiled == plain {np.array_equal(got, plain)}, "
                 f"compiled == PIL's pixels {np.array_equal(got, want)}")
        if want.shape[:2] == (822, 1237):
            times[name] = (c_ms, p_ms)
    print(f"  JPEG fixtures: {len(names)} files, the compiled decoder bit-equal to the plain one "
          f"and to PIL's committed pixels on each")
    return plain_ms, times


def check_image_forms(tmp, px):
    """The BMP, TIFF, 4-component JPEG, WebP, GIF, PPM / PGM / PFM, TGA and
    JPEG-in-TIFF forms at full width: one view's pixels `px` written in
    each (the CMYK JPEGs from `cmyk_of`, the WebP by `vp8l_form`, the GIF
    by `gif_form`, the PPMs by `ppm_form`, the TGAs by `tga_form`, the
    JPEG-in-TIFFs by `jpeg_tiff_form`), each decoded by
    `image_io.open_image` three times. The lossless forms must give back
    the pixels written (a 16-bit TIFF its high bytes, a 16-bit P6 the
    values PIL's round(v / 65535 * 255) gives, which are `px`, a 16-bit P5
    its values as mode I, the PFM its floats, the RLE8 BMP, the GIF and the
    colour-mapped TGA their indices); the JPEGs mode CMYK within 30 dB PSNR
    of PIL's CMYK for the samples written, and `to_rgba` this script's
    cmyk2rgb of them; the JPEG-in-TIFFs (strips, tiles) the compiled
    decoder's reading of each strip or tile as a standalone JPEG, within
    30 dB PSNR of `px`. The 1920x1080 WebP files of tests/fixtures/torch_webp
    (lossy, lossy with alpha, lossless) and the JPEG-in-TIFF of
    tests/fixtures/torch_tiff_jpeg, each decoded three times, must give the
    mode, shape and SHA-256 of PIL's pixels committed beside them. Then
    every file of tests/fixtures/torch_images, torch_ppm_tga and
    torch_tiff_jpeg must give PIL's mode, pixels and convert("RGBA")
    committed beside it. Prints the median decode ms per form."""
    H, W = px.shape[:2]
    idx = (px[..., 0] // 43) * 36 + (px[..., 1] // 43) * 6 + px[..., 2] // 43
    levels = np.stack(np.meshgrid(*[np.arange(6)] * 3, indexing="ij"), -1).reshape(-1, 3) * 51
    pil_cmyk, stored = cmyk_of(px)
    yy, xx = np.mgrid[0:H, 0:W]
    low = ((xx + 3 * yy) & 127)[..., None]
    wide = px.astype(np.int64) * 257 + np.where(px < 255, low, -low)  # round(wide / 65535 * 255) == px
    grey16 = wide[..., 1:2] // 2 + 100
    floats = (px[..., 0].astype(np.float32) - 127.5) / 64.0
    strips, strip_jpegs = jpeg_tiff_form(px, CLI_JPEG_QUALITY, CLI_JPEG_TIFF_ROWS)
    tiles, tile_jpegs = jpeg_tiff_form(px, CLI_JPEG_QUALITY, tile=(256, 256))
    ycbcr, ycbcr_jpegs = ycbcr_tiff_form(px, CLI_JPEG_QUALITY, CLI_JPEG_TIFF_ROWS)
    forms = {  # name: (file bytes, the pixels they hold; None: PIL's CMYK for the samples written)
        "TIFF raw 8-bit": (tiff_form(px, 8), px),
        "TIFF raw 16-bit": (tiff_form(wide_samples(px), 16), px),
        "TIFF PackBits 8-bit": (tiff_form(px, 8, 32773), px),
        "TIFF LZW + predictor 16-bit": (tiff_form(wide_samples(px), 16, 5, 2), px),
        "TIFF deflate + predictor 8-bit": (tiff_form(px, 8, 8, 2), px),
        "BMP 24-bit": (bmp_form(bmp_rows(px[..., ::-1].reshape(H, -1)), W, H, 24), px),
        "BMP RLE8": (bmp_form(rle8_encode(idx), W, H, 8, 1, palette=levels), idx[..., None]),
        "JPEG CMYK": (encode_jpeg(stored, CLI_JPEG_QUALITY, (2, 2), 0, adobe=0), None),
        "JPEG YCCK": (encode_jpeg(stored, CLI_JPEG_QUALITY, (2, 2), 0, adobe=2), None),
        "WebP VP8L (literal codes)": (vp8l_form(px), px),
        "GIF interlaced (literal LZW)": (gif_form(idx, np.concatenate([levels, np.zeros((40, 3), int)]),
                                                 interlace=True), idx[..., None]),
        "PPM P6 8-bit": (ppm_form(b"P6", px), px),
        "PPM P6 16-bit (scaled)": (ppm_form(b"P6", wide, 65535), px),
        "PGM P5 16-bit (mode I)": (ppm_form(b"P5", grey16, 65535), grey16.astype(np.int32)),
        "PPM P3 plain": (ppm_form(b"P3", px, plain=True), px),
        "PFM Pf": (ppm_form(b"Pf", floats), floats[..., None]),
        "TGA raw 24-bit": (tga_form(px, 2, 0x00), px),
        "TGA RLE 32-bit": (tga_form(opaque(px), 10), opaque(px)),
        "TGA colour-mapped RLE": (tga_form(idx[..., None].astype(np.uint8), 9, colormap=levels), idx[..., None]),
        "JPEG-in-TIFF strips": (strips, "strips"),
        "JPEG-in-TIFF tiles 256x256": (tiles, "tiles"),
        "YCbCr JPEG-in-TIFF 4:2:0": (ycbcr, "ycbcr"),
        "TIFF planar LZMA BigTIFF": (tiff_form(px, 8, 34925, None, CLI_PLANAR_ROWS, planar=True, big=True), px),
        "TIFF planar deflate + predictor 16-bit": (tiff_form(wide_samples(px), 16, 8, 2, 32, planar=True), px),
        "BigTIFF deflate + predictor 8-bit": (tiff_form(px, 8, 8, 2, 16, big=True), px),
    }
    standalone = {"strips": strip_jpegs, "tiles": tile_jpegs, "ycbcr": ycbcr_jpegs}
    times, cmyk_psnr = {}, {}
    path = os.path.join(tmp, "form")
    for name, (body, want) in forms.items():
        with open(path, "wb") as f:
            f.write(body)
        ms = []
        for _ in range(3):
            pic, t = synced_ms(image_io.open_image, path)
            ms.append(t)
        times[name] = float(np.median(ms))
        if isinstance(want, str):  # JPEG-in-TIFF: each strip or tile as the regular decoder reads it alone
            parts = [jpeg.decode_jpeg(b, f"{name} part {i}") for i, b in enumerate(standalone[want])]
            if want != "tiles":
                alone = np.concatenate(parts)
            else:
                across = -(-W // 256)
                alone = np.concatenate([np.concatenate(parts[r * across:(r + 1) * across], 1)
                                        for r in range(len(parts) // across)])[:H, :W]
            mse = float(np.mean((pic.pixels.astype(np.float64) - px) ** 2)) if pic.pixels.shape == px.shape \
                else math.inf
            cmyk_psnr[name] = 10 * math.log10(255 ** 2 / max(mse, 1e-12))
            if pic.mode != "RGB" or not np.array_equal(pic.pixels, alone) or not cmyk_psnr[name] >= 30.0:
                fail(f"cli path: the {name} file reads as {pic.mode} {pic.pixels.shape}, equal to its "
                     f"strips or tiles read alone {np.array_equal(pic.pixels, alone)}, "
                     f"{cmyk_psnr[name]:.2f} dB PSNR from the pixels written")
            continue
        if want is not None:
            if not np.array_equal(pic.pixels, want) or pic.pixels.dtype != want.dtype:
                fail(f"cli path: the {name} file decodes to other pixels than it holds "
                     f"({pic.pixels.shape} {pic.pixels.dtype} {pic.mode})")
            continue
        if pic.mode != "CMYK" or pic.pixels.shape != pil_cmyk.shape:
            fail(f"cli path: the {name} file decodes as {pic.mode} {pic.pixels.shape}")
        mse = float(np.mean((pic.pixels.astype(np.float64) - pil_cmyk) ** 2))
        cmyk_psnr[name] = 10 * math.log10(255 ** 2 / max(mse, 1e-12))
        if not cmyk_psnr[name] >= 30.0 or not np.array_equal(image_io.to_rgba(pic), cmyk_to_rgba(pic.pixels)):
            fail(f"cli path: the {name} file: {cmyk_psnr[name]:.2f} dB PSNR, to_rgba == cmyk2rgb "
                 f"{np.array_equal(image_io.to_rgba(pic), cmyk_to_rgba(pic.pixels))}")
    readings = {}
    for folder in (WEBP_FIXTURES, TIFF_JPEG_FIXTURES, TIFF_FORMS_FIXTURES):
        with open(os.path.join(folder, "sha256.json")) as f:
            readings.update({os.path.join(folder, k): v for k, v in json.load(f).items()})
    readings.update({os.path.join(JP2_FIXTURES, k): jp2_readings()[k] for k in JP2_LARGE})
    readings[os.path.join(JP2_PART1_FIXTURES, JP2_PART1_LARGE)] = jp2_part1_readings()[JP2_PART1_LARGE]
    readings[os.path.join(HT_FIXTURES, HT_VIEW)] = ht_readings()[HT_VIEW]
    readings[os.path.join(PART2_FIXTURES, PART2_VIEW)] = part2_readings()[PART2_VIEW]
    made = form_files()  # the GIS forms this script writes, PIL's reading of each committed
    for path, want in readings.items():
        name = os.path.basename(path)
        if name in made:
            if "file_sha256" in want and hashlib.sha256(made[name]).hexdigest() != want["file_sha256"]:
                fail(f"cli path: this script's writer made other bytes for '{name}' than the file PIL read "
                     f"(tests/fixtures/torch_tiff_forms/sha256.json)")
            path = os.path.join(tmp, "made.tif")
            with open(path, "wb") as f:
                f.write(made[name])
        ms = []
        for _ in range(3):
            pic, t = synced_ms(image_io.open_image, path)
            ms.append(t)
        times[f"{name} (PIL's committed hash)"] = float(np.median(ms))
        digest = sha256_of(pic.pixels)
        if (pic.mode, list(pic.pixels.shape), digest) != (want["mode"], want["shape"], want["sha256"]):
            fail(f"cli path: {name} reads as {pic.mode} {pic.pixels.shape} with SHA-256 {digest}, not PIL's "
                 f"{want['mode']} {want['shape']} {want['sha256']}")
    rest_ms, rest_small = check_tiff_rest_forms(tmp)
    pil_jp2 = pil_jp2_ms()
    names = {folder: sorted(f for f in os.listdir(folder) if os.path.exists(
        os.path.join(folder, os.path.splitext(f)[0] + ".npz")) and not f.endswith(".npz"))
        for folder in (IMAGE_FIXTURES, PPM_TGA_FIXTURES, TIFF_JPEG_FIXTURES)}
    for folder, files in names.items():
        if not files:
            fail(f"cli path: no image fixtures in {folder}")
        for name in files:
            want = np.load(os.path.join(folder, os.path.splitext(name)[0] + ".npz"))
            pic = image_io.open_image(os.path.join(folder, name))
            floats = want["pixels"].dtype.kind == "f"  # a PFM's NaN reads as NaN
            if not (pic.mode == str(want["mode"]) and pic.pixels.dtype == want["pixels"].dtype
                    and np.array_equal(pic.pixels, want["pixels"], equal_nan=floats)
                    and np.array_equal(image_io.to_rgba(pic), want["rgba"])):
                fail(f"cli path: image fixture {name} reads as {pic.mode}, not PIL's {want['mode']} and its "
                     f"pixels")
    small_jp2 = [(JP2_FIXTURES, name, jp2_readings()[name])
                 for name in sorted(set(jp2_readings()) - set(JP2_LARGE))]
    small_jp2 += [(JP2_PART1_FIXTURES, name, jp2_part1_readings()[name])
                  for name in sorted(set(jp2_part1_readings()) - {JP2_PART1_LARGE})]
    small_jp2 += [(HT_FIXTURES, name, ht_readings()[name]) for name in sorted(set(ht_readings()) - {HT_VIEW})]
    small_jp2 += [(PART2_FIXTURES, name, part2_readings()[name])
                  for name in sorted(set(part2_readings()) - {PART2_VIEW})]
    for folder, name, want in small_jp2:
        if want.get("raises"):  # PIL raises: the port raises a ValueError naming the file
            try:
                image_io.open_image(os.path.join(folder, name))
            except ValueError as err:
                if name not in str(err):
                    fail(f"cli path: JPEG 2000 fixture {name} raises without naming the file: {err}")
                continue
            fail(f"cli path: JPEG 2000 fixture {name} of {os.path.relpath(folder, ROOT)} reads; PIL raises")
        pic = image_io.open_image(os.path.join(folder, name))
        got = (pic.mode, list(pic.pixels.shape), sha256_of(pic.pixels), sha256_of(image_io.to_rgba(pic)))
        if got != (want["mode"], want["shape"], want["sha256"], want["rgba_sha256"]):
            fail(f"cli path: JPEG 2000 fixture {name} of {os.path.relpath(folder, ROOT)} reads as {pic.mode} "
                 f"{pic.pixels.shape}, not PIL's {want['mode']} {want['shape']} and its pixels and RGBA")
    print(f"  image forms at {W}x{H}, decode ms (median of 3, host clock): "
          + ", ".join(f"{k} {v:.2f}" for k, v in times.items())
          + f"; lossless forms bit-equal, CMYK / YCCK JPEG (q{CLI_JPEG_QUALITY} 4:2:0) and JPEG-in-TIFF "
          + ", ".join(f"{k} {v:.2f}" for k, v in cmyk_psnr.items())
          + f" dB PSNR from PIL's CMYK of the samples written and from the view (JPEG-in-TIFF bit-equal to "
          f"its strips and tiles read alone); {len(readings)} 1080p WebP, JPEG-in-TIFF, ZSTD, LZMA, planar, "
          f"BigTIFF and JPEG 2000 files (the 800x800 RGBA JPEG 2000 frame, the Part 1 codestream with "
          f"every code-block style, SOP, EPH and a POC, the HTJ2K codestream and the 20-bit Part 2 codestream "
          f"too) give PIL's committed SHA-256; {len(small_jp2)} small JPEG 2000 files of "
          f"{os.path.relpath(JP2_FIXTURES, ROOT)}, {os.path.relpath(JP2_PART1_FIXTURES, ROOT)}, "
          f"{os.path.relpath(HT_FIXTURES, ROOT)} (HTJ2K, the HT frame too) and "
          f"{os.path.relpath(PART2_FIXTURES, ROOT)} (Part 2 and 17- to 31-bit, the Part 2 frame too) PIL's mode, "
          f"pixels and RGBA, or a raise where PIL raises; {pil_jp2}; "
          + ", ".join(f"{len(v)} {os.path.relpath(k, ROOT)}" for k, v in names.items())
          + " files give PIL's committed mode, pixels and RGBA")
    print(f"  TIFF forms of fax archives, old JPEG-in-TIFF writers, YCbCr scanners, float / CIELab pipelines and "
          f"ThunderScan at {W}x{H} (SHA-256 equal to PIL's committed pixels), decode ms (median of 3, host "
          f"clock), the port / PIL: " + ", ".join(f"{k} {a:.2f} / {b}" for k, (a, b) in rest_ms.items())
          + f"; {rest_small} small files of {os.path.relpath(TIFF_REST_FIXTURES, ROOT)} give PIL's committed "
          f"mode, pixels and RGBA (CIELab's through this port's copy of LittleCMS's transform)")


def check_tiff_rest_forms(tmp):
    """The 1080p fax (PIL-written Group 4 and Group 3 2-D, committed),
    old-style JPEG, YCbCr deflate, float with Predictor 3, CIELab and
    ThunderScan files (`rest_form_files`), each decoded by
    `image_io.open_image` three times (and by PIL three times where this
    machine has it), must give the mode, shape and SHA-256 of PIL's pixels
    committed in tests/fixtures/torch_tiff_rest/sha256.json; the small
    files committed there PIL's mode, pixels and RGBA. Returns {name: (the
    port's median ms, PIL's median ms or "not measured")} and the number
    of small files."""
    with open(os.path.join(TIFF_REST_FIXTURES, "sha256.json")) as f:
        readings = json.load(f)
    made = rest_form_files()
    have_pil = importlib.util.find_spec("PIL") is not None
    times, small = {}, 0
    for name, want in readings.items():
        if name in made:
            if "file_sha256" in want and hashlib.sha256(made[name]).hexdigest() != want["file_sha256"]:
                fail(f"cli path: this script's writer made other bytes for '{name}' than the file PIL read "
                     f"(tests/fixtures/torch_tiff_rest/sha256.json)")
            path = os.path.join(tmp, "rest.tif")
            with open(path, "wb") as f:
                f.write(made[name])
        else:
            path = os.path.join(TIFF_REST_FIXTURES, name)
        if "rgba_sha256" in want:  # a small file: its pixels and RGBA
            pic = image_io.open_image(path)
            got = (pic.mode, list(pic.pixels.shape), sha256_of(pic.pixels))
            rgba_ok = sha256_of(image_io.to_rgba(pic)) == want["rgba_sha256"]
            if got != (want["mode"], want["shape"], want["sha256"]) or not rgba_ok:
                fail(f"cli path: TIFF fixture {name} reads as {pic.mode} {pic.pixels.shape}, not PIL's committed "
                     f"{want['mode']} {want['shape']} pixels and RGBA")
            small += 1
            continue
        ms, pil_ms = [], []
        for _ in range(3):
            pic, t = synced_ms(image_io.open_image, path)
            ms.append(t)
            if have_pil:
                from PIL import Image

                t0 = time.perf_counter()
                with Image.open(path) as im:
                    np.asarray(im)
                pil_ms.append((time.perf_counter() - t0) * 1e3)
        digest = sha256_of(pic.pixels)
        if (pic.mode, list(pic.pixels.shape), digest) != (want["mode"], want["shape"], want["sha256"]):
            fail(f"cli path: {name} reads as {pic.mode} {pic.pixels.shape} with SHA-256 {digest}, not PIL's "
                 f"{want['mode']} {want['shape']} {want['sha256']}")
        times[name] = (float(np.median(ms)), f"{np.median(pil_ms):.2f}" if pil_ms else "not measured")
    if len(times) != 7:
        fail(f"cli path: {len(times)} 1080p TIFF forms of tests/fixtures/torch_tiff_rest, not 7")
    return times, small


class SceneLoadTimer:
    """Wall time of the train CLI's `Scene(...)` (the dataset read, every
    view decoded and converted, input.ply and cameras.json written) while
    patched (`with`)."""

    def __enter__(self):
        self.cls, self.s = train_cli.Scene, None
        timer = self

        class Timed(self.cls):
            def __init__(self, *args, **kw):
                t0 = time.perf_counter()
                super().__init__(*args, **kw)
                timer.s = time.perf_counter() - t0

        train_cli.Scene = Timed
        return self

    def __exit__(self, *exc):
        train_cli.Scene = self.cls


def in_process(main, *args, **kw):
    """A CLI's main(); safe_state replaces sys.stdout (and drops every line
    with --quiet), so it is restored afterwards."""
    stdout = sys.stdout
    try:
        return main(*args, **kw)
    finally:
        sys.stdout = stdout


def dc_colors(model):
    """The point colours of a COLMAP dataset of the model (the dict
    `load_gaussians_ply` gives): its centres' DC colour as uint8."""
    return (np.clip(0.5 + gsmath.SH_C0 * model["features_dc"][:, 0, :], 0.0, 1.0) * 255).astype(np.uint8)


def orbit_dataset(n, W, H):
    """`n` views of the trained model on phase 5c's orbit (2.5 x the 95th
    percentile radius around its mean, fov 70 degrees across) at W x H:
    the cameras, named view_<i>, and their `eval_render`s through the
    kernels, quantised as the render CLI writes them."""
    trained = params_from_ply(TRAINED_PLY)
    xyz = trained.xyz.detach().cpu().numpy()
    center = xyz.mean(axis=0)
    dist = 2.5 * float(np.quantile(np.linalg.norm(xyz - center, axis=1), 0.95))
    bg0 = torch.zeros(3, device=trained.xyz.device)
    cams, images = [], []
    with torch.no_grad():
        acts = tuple(activate(trained))
        for i in range(n):
            cam = orbit_camera(center, dist, 2 * math.pi * i / n, W, H, 70.0, 70.0 * H / W)
            cam.image_name = f"view_{i:02d}"
            arr = cam.arrays(device=trained.xyz.device)
            k = int(preprocess(*acts, 3, arr, W, H, 32, 32).tiles_touched.sum())
            img = eval_render(trained, arr, bg0, 3, W, H,
                              RasterizerConfig(capacity_exact=entry_bucket_capacity(k, 16, 1.2)))[0]
            cams.append(cam)
            images.append(quantize(img))
    return cams, images


def run_train_cli(argv):
    """`cli.train.main(argv)` in process on the card; returns (scene,
    trainer, wall s, the Scene's load s, each tensorboard panel's ms)."""
    with PanelTimer() as panels, SceneLoadTimer() as scene_load:
        t0 = time.perf_counter()
        scene, tr = in_process(train_cli.main, argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if scene_load.s is None:
        fail(f"the train CLI made no Scene ({argv})")
    return scene, tr, wall, scene_load.s, panels.ms


def check_trainer_state(name, tr, cam, seed):
    """check_state at a trainer's state (its padded rows, the dead ones the
    reset and prunes left, its entry capacity) and the Camera `cam`, at
    the camera's size."""
    p = tr.state.params
    return check_state(name, p, tr.active_sh_degree, cam.arrays(device=p.xyz.device), tr.background,
                       tr.raster_cfg.capacity(p.num_points), (tr.raster_cfg.tile_w, tr.raster_cfg.tile_h),
                       seed, W=cam.width, H=cam.height)


def train_cli_on(tag, data, model_dir, n_views, steps, seed):
    """Phases 5h-5r (b): `cli.train` -r 1 for `steps` iterations on the
    COLMAP dataset at `data` of `n_views` views at W_MAIN x H_MAIN. Fails
    unless it ran the steps on every view at full size with finite losses
    and one launch of each train-path kernel a step; holds the kernels to
    their plain versions at its final state. Returns (the launches, their
    max abs errors, the run's train s, scene load s, step median ms, first
    and last loss)."""
    reset_launches()
    scene, tr, train_s, load_s, _ = run_train_cli(["-s", data, "-m", model_dir, "-r", "1", "--iterations",
                                                   str(steps), "--disable_viewer", "--quiet"])
    launches = {k: LAUNCH_COUNTERS[k].launches for k in TRAIN_KERNELS}
    views = scene.get_train_cameras()
    if tr.iteration != steps or len(views) != n_views or \
            sorted({(c.width, c.height) for c in views}) != [(W_MAIN, H_MAIN)]:
        fail(f"{tag}: the train CLI ran {tr.iteration} steps on {len(views)} views")
    losses_ = [h["loss"] for h in tr.history]
    if not all(math.isfinite(x) for x in losses_):
        fail(f"{tag}: the loss is not finite: {losses_}")
    if launches != {k: steps for k in TRAIN_KERNELS}:
        fail(f"{tag}: train CLI launches {launches}, not one of each a step")
    step_ms = float(np.median([h["iter_time_ms"] for h in tr.history]))
    errs = check_trainer_state(f"{tag} train CLI final state", tr, views[0], seed)
    del scene, tr
    return launches, errs, (train_s, load_s, step_ms, losses_[0], losses_[-1])


def form_dataset(tmp, views, write):
    """Phases 5h-5r (b): a COLMAP dataset in `tmp`/data of trained_r5 on
    phase 5c's orbit at W_MAIN x H_MAIN, one view for each of `views`,
    each view's PNG replaced by the file `write(i, cam, render, view,
    stem)` writes (`stem`: images/<view name>, no extension; it returns the
    file's name within images/). Returns a namespace: data, model_dir,
    cams, images (the renders), files ({view name: file name}), cameras
    (the train cameras `read_colmap_scene` reads back) and build_s (the
    seconds from the renders to the renamed views)."""
    t0 = time.perf_counter()
    data = os.path.join(tmp, "data")
    model = load_gaussians_ply(TRAINED_PLY)
    cams, images = orbit_dataset(len(views), W_MAIN, H_MAIN)
    write_colmap_scene(data, cams, images, model["xyz"], dc_colors(model))
    files = {}
    for i, (cam, px, view) in enumerate(zip(cams, images, views)):
        os.remove(os.path.join(data, "images", f"{cam.image_name}.png"))
        files[cam.image_name] = write(i, cam, px, view, os.path.join(data, "images", cam.image_name))
    rename_views(data, files)
    build_s = time.perf_counter() - t0
    return types.SimpleNamespace(data=data, model_dir=os.path.join(tmp, "model"), cams=cams, images=images,
                                 files=files, build_s=build_s,
                                 cameras=read_colmap_scene(data, None, eval_split=False).train_cameras)


def write_file(path, body: bytes):
    with open(path, "wb") as f:
        f.write(body)


def render_cli_dir(model_dir, split, method, n):
    """The render CLI's output directory of a split, which must hold n
    renders and n ground truths, 00000.png on."""
    out = os.path.join(model_dir, split, method)
    for kind in ("renders", "gt"):
        got = sorted(os.listdir(os.path.join(out, kind)))
        if got != [f"{i:05d}.png" for i in range(n)]:
            fail(f"{split}/{method}/{kind} holds {got}, not {n} PNGs")
    return out


def metrics_cli_line(model_dir, method, n_test, dev, where):
    """`cli.metrics.main(["-m", model_dir])`: `method`'s SSIM, PSNR and
    LPIPS finite, the PSNR within 1e-4 dB of a float64 one from its test
    PNGs and the LPIPS within rel 1e-4 of `lpips` on them. Returns the
    line to print."""
    _, metrics_ms = synced_ms(in_process, metrics_cli.main, ["-m", model_dir])
    with open(os.path.join(model_dir, "results.json")) as f:
        result = json.load(f).get(method, {})
    if not all(math.isfinite(result.get(k) or math.nan) for k in ("SSIM", "PSNR", "LPIPS")):
        fail(f"{where}: results.json holds {result}")
    psnrs, lpipss = [], []
    out = os.path.join(model_dir, "test", method)
    for i in range(n_test):
        r = image_io.read_png(os.path.join(out, "renders", f"{i:05d}.png")).astype(np.float64) / 255
        g = image_io.read_png(os.path.join(out, "gt", f"{i:05d}.png")).astype(np.float64) / 255
        psnrs.append(20 * math.log10(1 / math.sqrt(float(np.mean((r - g) ** 2)))))
        lpipss.append(float(lpips_mod.lpips(torch.tensor(r, dtype=torch.float32, device=dev),
                                            torch.tensor(g, dtype=torch.float32, device=dev))))
    if abs(float(np.mean(psnrs)) - result["PSNR"]) > 1e-4:
        fail(f"{where}: PSNR {result['PSNR']} vs {np.mean(psnrs)} recomputed from the PNGs")
    if abs(float(np.mean(lpipss)) - result["LPIPS"]) > 1e-4 * abs(float(np.mean(lpipss))):
        fail(f"{where}: LPIPS {result['LPIPS']} vs {np.mean(lpipss)} from the PNGs")
    return (f"  metrics CLI: {metrics_ms:.1f} ms for {n_test} views; SSIM {result['SSIM']:.6f}, PSNR "
            f"{result['PSNR']:.6f} dB (float64 from the PNGs {np.mean(psnrs):.6f}), LPIPS (vgg, "
            f"seeded random weights) {result['LPIPS']:.7f} (lpips on the PNGs {np.mean(lpipss):.7f})")


def cli_phase(dev):
    """Phase 5c: the user's entry path, the train, render and metrics CLIs
    in process on a COLMAP dataset at 1920x1080. Returns the compositing
    kernels' launches in the train and render CLIs and the max abs errors
    of the forward, the backward and the routing against their plain
    versions at the train CLI's final state."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        return _cli_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _cli_phase(dev, tmp):
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    data, model_dir = os.path.join(tmp, "data"), os.path.join(tmp, "model")
    bg0 = torch.zeros(3, device=dev)

    # The dataset: trained_r5's renders from 16 orbit views, its centres
    # coloured by the DC term, through the port's COLMAP and PNG writers;
    # then the train views rewritten as JPEG by this script's encoder.
    model = load_gaussians_ply(TRAINED_PLY)
    cams, images = orbit_dataset(CLI_VIEWS, W_MAIN, H_MAIN)
    names = sorted(c.image_name for c in cams)
    test_names = set(names[::8])  # llffhold=8: the views the train CLI holds out
    t0 = time.perf_counter()
    write_colmap_scene(data, cams, images, model["xyz"], dc_colors(model))
    files, jpeg_encode_ms = train_view_files(data, cams, images, test_names)
    write_ms = (time.perf_counter() - t0) * 1e3
    encode_ms = []
    for px in images[:4]:
        _, ms = synced_ms(image_io.write_png, os.path.join(tmp, "encode.png"), px)
        encode_ms.append(ms)
    _, resize_ms = synced_ms(image_io.resize, images[0], (1600, 900))

    # The port's readers give back every camera, every PNG pixel and every
    # JPEG view close to its render (a lossy encode).
    info = read_colmap_scene(data, None, eval_split=False)
    by_name = {c.image_name: c for c in info.train_cameras}
    decode_ms, jpeg_ms, psnr, damaged, lossless_ms = [], [], [], {}, {}
    for cam, px in zip(cams, images):
        got = by_name[cam.image_name]
        if float(np.abs(got.R - cam.R).max()) > 1e-12 or float(np.abs(got.T - cam.T).max()) > 1e-12:
            fail(f"cli path: camera {cam.image_name} did not survive the COLMAP files")
        if os.path.basename(got.image_path) != files[cam.image_name]:
            fail(f"cli path: images.bin names {got.image_path} for {cam.image_name}")
        if cam.image_name in test_names:
            back, ms = synced_ms(image_io.read_png, got.image_path)
            decode_ms.append(ms)
            if not np.array_equal(back, px):
                fail(f"cli path: image {cam.image_name} did not survive its PNG")
            continue
        if cam.image_name == names[CLI_JP2_VIEW]:  # the fixture's picture: PIL's committed hash
            pic, jp2_view_ms = synced_ms(image_io.open_image, got.image_path)
            want = jp2_readings()[JP2_VIEW]
            if (pic.mode, list(pic.pixels.shape), sha256_of(pic.pixels)) != (want["mode"], want["shape"],
                                                                             want["sha256"]):
                fail(f"cli path: the JPEG 2000 view {got.image_path} reads as {pic.mode} {pic.pixels.shape}, "
                     f"not PIL's committed {want['mode']} {want['shape']} pixels")
            continue
        if cam.image_name == names[CLI_HT_VIEW]:  # the HTJ2K fixture's picture: PIL's committed hash
            pic, ht_view_ms = synced_ms(image_io.open_image, got.image_path)
            want = ht_readings()[HT_VIEW]
            if (pic.mode, list(pic.pixels.shape), sha256_of(pic.pixels)) != (want["mode"], want["shape"],
                                                                             want["sha256"]):
                fail(f"cli path: the HTJ2K view {got.image_path} reads as {pic.mode} {pic.pixels.shape}, "
                     f"not PIL's committed {want['mode']} {want['shape']} pixels")
            continue
        if cam.image_name == names[CLI_PART2_VIEW]:  # the Part 2 fixture's picture: PIL's committed hash
            pic, part2_view_ms = synced_ms(image_io.open_image, got.image_path)
            want = part2_readings()[PART2_VIEW]
            if (pic.mode, list(pic.pixels.shape), sha256_of(pic.pixels)) != (want["mode"], want["shape"],
                                                                             want["sha256"]):
                fail(f"cli path: the Part 2 view {got.image_path} reads as {pic.mode} {pic.pixels.shape}, "
                     f"not PIL's committed {want['mode']} {want['shape']} pixels")
            continue
        if cam.image_name == names[CLI_YCBCR_UNITS_VIEW]:  # libtiff's YCbCr -> RGB of the units written
            back, ycbcr_units_ms = synced_ms(image_io.read_image, got.image_path)
            want = tiff_ycbcr_to_rgb(ycbcr_strips(px)[1])
            mse = float(np.mean((back.astype(np.float64) - px) ** 2)) if back.shape == px.shape else math.inf
            ycbcr_units_psnr = 10 * math.log10(255 ** 2 / max(mse, 1e-12))
            if not np.array_equal(back, want) or not ycbcr_units_psnr >= 30.0:
                fail(f"cli path: the YCbCr LZW view {got.image_path} reads as {back.shape}, equal to libtiff's "
                     f"conversion of its units {np.array_equal(back, want)}, {ycbcr_units_psnr:.2f} dB PSNR")
            continue
        lossy = got.image_path.endswith(".jpg") or cam.image_name in (names[CLI_JPEG_TIFF_VIEW],
                                                                      names[CLI_YCBCR_VIEW])
        if not lossy:  # the TIFF (planar BigTIFF included), BMP, WebP, PPM and TGA views
            back, ms = synced_ms(image_io.read_image, got.image_path)
            lossless_ms[os.path.basename(got.image_path)] = ms
            if not np.array_equal(back, opaque(px) if cam.image_name == names[CLI_TGA_VIEW] else px):
                fail(f"cli path: image {got.image_path} did not survive its file")
            continue
        back, ms = synced_ms(image_io.read_image, got.image_path)
        if cam.image_name == names[CLI_JPEG_TIFF_VIEW]:
            jpeg_tiff_ms = ms
        elif cam.image_name == names[CLI_YCBCR_VIEW]:
            ycbcr_ms = ms
        else:
            jpeg_ms.append(ms)
        mse = float(np.mean((back.astype(np.float64) - px) ** 2)) if back.shape == px.shape else math.inf
        view_psnr = 10 * math.log10(255 ** 2 / max(mse, 1e-12))
        if cam.image_name in (names[CLI_FLIPPED_VIEW], names[CLI_EXTRANEOUS_VIEW]):
            plain = jpeg.read_jpeg(got.image_path, plain=True)
            if not np.array_equal(back, plain):
                fail(f"cli path: the compiled JPEG decoder differs from the plain one on the damaged "
                     f"view {cam.image_name} at {int((back != plain).any(-1).sum())} pixels")
            damaged[cam.image_name] = view_psnr
        psnr.append(view_psnr)
        if not psnr[-1] >= 30.0:
            fail(f"cli path: JPEG view {cam.image_name} decodes {back.shape} at {psnr[-1]:.2f} dB "
                 f"PSNR from its render")
        if cam.image_name == names[CLI_JPEG_TIFF_VIEW]:
            jpeg_tiff_psnr = psnr.pop()
        elif cam.image_name == names[CLI_YCBCR_VIEW]:
            ycbcr_psnr = psnr.pop()
    if not np.array_equal(info.points, model["xyz"]):
        fail("cli path: the points did not survive points3D.bin")
    print(f"cli path: a COLMAP dataset of {CLI_VIEWS} views at {W_MAIN}x{H_MAIN} and "
          f"{len(info.points)} points written in {write_ms:.1f} ms: {len(jpeg_ms)} train views "
          f"as baseline JPEG 4:2:0 q{CLI_JPEG_QUALITY} (this script's encoder, "
          f"{np.median(jpeg_encode_ms):.1f} ms a view; {files[names[CLI_RESTART_VIEW]]} with a "
          f"restart marker every MCU row), {files[names[CLI_TIFF_VIEW]]} as 16-bit RGB TIFF (LZW, "
          f"Predictor 2), {files[names[CLI_BMP_VIEW]]} as 24-bit BMP, {files[names[CLI_WEBP_VIEW]]} as "
          f"lossless WebP (this script's VP8L writer), {files[names[CLI_PPM_VIEW]]} as binary P6, "
          f"{files[names[CLI_TGA_VIEW]]} as 32-bit RLE TGA, {files[names[CLI_JPEG_TIFF_VIEW]]} as RGB "
          f"JPEG-in-TIFF (q{CLI_JPEG_QUALITY}, strips of {CLI_JPEG_TIFF_ROWS} rows; {jpeg_tiff_psnr:.2f} dB "
          f"PSNR from its render, decode {jpeg_tiff_ms:.1f} ms), {files[names[CLI_YCBCR_VIEW]]} as YCbCr "
          f"JPEG-in-TIFF (4:2:0; {ycbcr_psnr:.2f} dB, decode {ycbcr_ms:.1f} ms), {files[names[CLI_PLANAR_VIEW]]} "
          f"as a BigTIFF of LZMA planes, {files[names[CLI_YCBCR_UNITS_VIEW]]} as a YCbCr TIFF of LZW 4:2:0 data "
          f"units (libtiff's YCbCr -> RGB of the units bit for bit; {ycbcr_units_psnr:.2f} dB PSNR from its "
          f"render, decode {ycbcr_units_ms:.1f} ms), {files[names[CLI_JP2_VIEW]]} as a 9/7 tiled RPCL JPEG 2000 (PIL's "
          f"committed pixels, decode {jp2_view_ms:.1f} ms), {files[names[CLI_HT_VIEW]]} as an HTJ2K "
          f"codestream (RPCL, 64x64 HT code-blocks, cleanup passes; PIL's committed pixels, decode "
          f"{ht_view_ms:.1f} ms), {files[names[CLI_PART2_VIEW]]} as a JPEG 2000 Part 2 codestream of 20-bit RGB "
          f"(9/7, MCT / MCC / MCO offsets, CBD; PIL's committed pixels, decode {part2_view_ms:.1f} ms), "
          f"{len(decode_ms)} test views as PNG; "
          f"cameras within 1e-12, PNG, TIFF, BMP, WebP, PPM and TGA pixels bit-equal (decode "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in lossless_ms.items())
          + f"), JPEG views {min(psnr):.2f}-{max(psnr):.2f} dB PSNR from their renders through the port's "
          f"readers")
    print(f"  damaged train views, decoded by the compiled decoder bit-equal to the plain one: "
          f"{names[CLI_FLIPPED_VIEW]} (one flipped entropy-coded bit) "
          f"{damaged[names[CLI_FLIPPED_VIEW]]:.2f} dB PSNR from its render, "
          f"{names[CLI_EXTRANEOUS_VIEW]} (extraneous bytes before DQT and SOS) "
          f"{damaged[names[CLI_EXTRANEOUS_VIEW]]:.2f} dB")
    plain_ms, fixture_ms = check_jpeg_decoders(os.path.join(data, "images", files[names[CLI_RESTART_VIEW]]))
    print(f"  JPEG decode at {W_MAIN}x{H_MAIN} (baseline 4:2:0 q{CLI_JPEG_QUALITY}): compiled "
          f"{np.median(jpeg_ms):.2f} ms (median of {len(jpeg_ms)} views), plain "
          f"{plain_ms:.1f} ms ({files[names[CLI_RESTART_VIEW]]}, bit-equal); at 1237x822 "
          + ", ".join(f"{k} compiled {c:.2f} ms, plain {p:.1f} ms" for k, (c, p) in fixture_ms.items())
          + " (host clock)")
    check_image_forms(tmp, images[0])
    # A file as PIL or libpng writes one: Average and Paeth rows, which the
    # reader decodes by anti-diagonals (the cost of a real dataset).
    mixed = os.path.join(tmp, "every_filter.png")
    with open(mixed, "wb") as f:
        f.write(png_form(images[0], 8, 2, filters=(0, 1, 2, 3, 4)))
    mixed_ms = []
    for _ in range(3):
        back, ms = synced_ms(image_io.read_png, mixed)
        mixed_ms.append(ms)
        if not np.array_equal(back, images[0]):
            fail("cli path: the PNG with every row filter did not decode to its pixels")
    print(f"  PNG at {W_MAIN}x{H_MAIN} RGB: encode {np.median(encode_ms):.1f} ms, decode "
          f"{np.median(decode_ms):.1f} ms (the port's Sub-filtered files), decode "
          f"{np.median(mixed_ms):.1f} ms (rows cycling through all five filters, as a real "
          f"dataset's; bit-equal) (median, host clock); resize {W_MAIN}x{H_MAIN} -> 1600x900 "
          f"{resize_ms:.1f} ms")

    # Train. Each step's host time is the CLI's own iter_time_ms (the step
    # ends in a copy of its metrics to the host).
    reset_launches()
    scene, tr, train_s, load_s, panel_ms = run_train_cli(["-s", data, "-m", model_dir, *CLI_TRAIN])
    step_ms = [h["iter_time_ms"] for h in tr.history]
    train_launches = {k: LAUNCH_COUNTERS[k].launches for k in ("composite_fwd", "composite_bwd",
                                                               "route_grads")}
    n_train, n_test = CLI_VIEWS - CLI_VIEWS // 8, CLI_VIEWS // 8  # llffhold=8
    reports = len(CLI_REPORTS) * (n_test + 5)  # each report: the test views and 5 train views
    want = {"composite_fwd": CLI_STEPS + reports, "composite_bwd": CLI_STEPS,
            "route_grads": CLI_STEPS}
    losses_ = [h["loss"] for h in tr.history]
    first20, last20 = float(np.mean(losses_[:20])), float(np.mean(losses_[-20:]))
    print(f"  train CLI: {CLI_STEPS} steps, {n_train} train and {n_test} test views, wall "
          f"{train_s:.2f} s (scene load {load_s:.2f} s: {n_train - 11} JPEG, 1 TIFF, 1 BMP, 1 WebP, 1 P6, "
          f"1 RLE TGA, 1 JPEG-in-TIFF, 1 YCbCr JPEG-in-TIFF, 1 planar LZMA BigTIFF, 1 JPEG 2000, 1 HTJ2K, "
          f"1 JPEG 2000 Part 2 and "
          f"{n_test} PNG views decoded), step median {np.median(step_ms):.3f} ms, p80 "
          f"{np.percentile(step_ms, 80):.3f} ms (its iter_time_ms, host clock, deferred "
          f"maintenance excluded); loss first 20 {first20:.6f}, last 20 {last20:.6f}; "
          f"{len(tr.densify_history)} densifies ({[d['path'] for d in tr.densify_history]}); live "
          f"{tr.num_live}; launches {train_launches}")
    optional = {m: importlib.util.find_spec(m) is not None for m in ("tensorboard", "tqdm", "PIL")}
    print(f"  train CLI: tensorboard image panels {sum(panel_ms):.1f} ms ({len(panel_ms)} "
          f"add_images calls); importable here: {optional}")
    for f in ("cfg_args", "cameras.json", "input.ply", f"point_cloud/iteration_{CLI_SAVE}/point_cloud.ply",
              f"point_cloud/iteration_{CLI_STEPS}/point_cloud.ply", f"chkpnt{CLI_STEPS}.pth"):
        if not os.path.exists(os.path.join(model_dir, f)):
            fail(f"cli path: the train CLI wrote no {f}")
    if tr.iteration != CLI_STEPS or len(step_ms) != CLI_STEPS:
        fail(f"cli path: the train CLI stopped at iteration {tr.iteration}")
    if not tr.densify_history:
        fail("cli path: no densify ran")
    if not all(math.isfinite(x) for x in losses_) or not last20 < first20:
        fail(f"cli path: the loss did not fall (first 20 {first20}, last 20 {last20})")
    if train_launches != want:
        fail(f"cli path: train CLI launches {train_launches}, the schedule gives {want}")

    # The three train-path kernels at the train CLI's final state (its
    # padded rows, the dead ones the reset and prunes left, its capacity)
    # and a test camera, by phase 3's rules; their launches are not the
    # path's (the counters are reset before the render CLI).
    errs = check_trainer_state("train CLI final state", tr, scene.get_test_cameras()[0], 43)

    # The final PLY, reloaded, renders the bits of the trainer's own state.
    ply_path = os.path.join(model_dir, f"point_cloud/iteration_{CLI_STEPS}/point_cloud.ply")
    saved = params_from_ply(ply_path)
    arr = cams[0].arrays()
    with torch.no_grad():
        n = int(preprocess(*activate(saved), 3, arr, W_MAIN, H_MAIN, 32, 32).tiles_touched.sum())
    cfg = RasterizerConfig(capacity_exact=entry_bucket_capacity(n, 16, 1.2))
    ours = eval_render(tr.state.params, arr, bg0, 3, W_MAIN, H_MAIN, cfg)
    back = eval_render(saved, arr, bg0, 3, W_MAIN, H_MAIN, cfg)
    if not (torch.equal(ours[0], back[0]) and torch.equal(ours[1]["final_t"], back[1]["final_t"])):
        fail("cli path: the PLY at the last iteration does not render the trainer's bits")
    del scene, tr, ours, back

    # Render.
    reset_launches()
    _, render_ms = synced_ms(in_process, render_cli.main, ["-m", model_dir])
    render_launches = {k: LAUNCH_COUNTERS[k].launches for k in train_launches}
    if render_launches != {"composite_fwd": CLI_VIEWS, "composite_bwd": 0, "route_grads": 0}:
        fail(f"cli path: render CLI launches {render_launches} for {CLI_VIEWS} views")
    splits = {"test": names[::8], "train": [n for i, n in enumerate(names) if i % 8]}
    for split, split_names in splits.items():
        out = render_cli_dir(model_dir, split, f"ours_{CLI_STEPS}", len(split_names))
        for i, name in enumerate(split_names):
            gt = image_io.read_png(os.path.join(out, "gt", f"{i:05d}.png"))
            view = image_io.read_image(os.path.join(data, "images", files[name]))
            if view.shape[2] == 4 and (view[..., 3] == 255).all():  # the opaque TGA: its colour
                view = view[..., :3]
            if not np.array_equal(gt, view):
                fail(f"cli path: {split} gt {i} is not the dataset's {name}")
    # the render CLI's cameras: the ones its reader gives (R within 1e-12 of the orbit's)
    views = [load_camera(by_name[name], 1) for name in names]
    test_cam = views[names.index(splits["test"][0])]
    rcfg = RasterizerConfig(capacity_exact=render_cli.auto_capacity(saved, views, RasterizerConfig(), 3))
    want_png = quantize(eval_render(saved, test_cam.arrays(), bg0, 3, W_MAIN, H_MAIN, rcfg)[0])
    got_png = image_io.read_png(os.path.join(model_dir, "test", f"ours_{CLI_STEPS}", "renders", "00000.png"))
    if not np.array_equal(got_png, want_png):
        fail(f"cli path: the render CLI's test view differs from eval_render's at "
             f"{int((got_png != want_png).any(-1).sum())} pixels")
    print(f"  render CLI: {CLI_VIEWS} views in {render_ms / 1e3:.2f} s wall, "
          f"{render_ms / CLI_VIEWS:.1f} ms per view (scene load, render, two PNGs); launches "
          f"{render_launches}; gt PNGs bit-equal to the dataset's JPEG, TIFF, BMP, WebP, PPM, TGA, JPEG 2000 "
          f"and PNG "
          f"images, test view 0 bit-equal to eval_render of the reloaded PLY")

    # Metrics.
    print(metrics_cli_line(model_dir, f"ours_{CLI_STEPS}", n_test, dev, "cli path"))

    print(f"  phase peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
          f"wall {time.perf_counter() - t_phase:.1f} s")
    return train_launches, render_launches, errs


# ---- phase 5e: the Blender (NeRF-synthetic) path ----------------------------

def blender_frame(rgba, form, seed):
    """File bytes of an 8-bit RGBA frame in one of BLENDER_FORMS (or plain
    8-bit RGBA PNG), and the RGBA that PIL's convert("RGBA") gives for them
    by PIL's rules: a 16-bit file's high bytes, a palette entry's colour and
    tRNS alpha, grey spread to RGB, alpha 0 on a tRNS colour, a BMP's BGRA
    bytes under its alpha mask, a GIF's palette colour with alpha 0 on its
    transparency index, a TGA's BGRA, a 16-bit P6's round(v / 65535 * 255)
    (its colour, which has no alpha, opaque), a 16-bit planar RGBA TIFF's
    high bytes. An RGBA JPEG 2000 is the committed 800x800 frame, an RGBA
    HTJ2K the committed 800x800 HT frame, an RGBA JPEG 2000 Part 2 the
    committed 800x800 Part 2 frame (each one's RGBA is held to PIL's
    committed SHA-256: the second value is None). A CMYK JPEG (Adobe transform 0, of the
    frame composited on white, which it has no alpha for) is lossy: for it
    the second value is PIL's CMYK of the samples written (`cmyk_of`)."""
    if form is None:
        return None, rgba
    if form == "RGBA JPEG 2000":  # the committed frame, its own picture: held to PIL's hash, not to `rgba`
        with open(os.path.join(JP2_FIXTURES, JP2_FRAME), "rb") as f:
            return f.read(), None
    if form == "RGBA HTJ2K":  # the committed HT frame, the same way
        with open(os.path.join(HT_FIXTURES, HT_FRAME), "rb") as f:
            return f.read(), None
    if form == "RGBA JPEG 2000 Part 2":  # the committed Part 2 frame, the same way
        with open(os.path.join(PART2_FIXTURES, PART2_FRAME), "rb") as f:
            return f.read(), None
    if form == "CMYK JPEG":
        a = rgba[..., 3:].astype(np.int64)
        on_white = ((rgba[..., :3] * a + 255 * (255 - a) + 127) // 255).astype(np.uint8)
        pil_cmyk, stored = cmyk_of(on_white)
        return encode_jpeg(stored, CLI_JPEG_QUALITY, (2, 2), 0, adobe=0), pil_cmyk
    if form == "32-bit BMP with alpha":
        H, W = rgba.shape[:2]
        return bmp_form(bmp_rows(rgba[..., [2, 1, 0, 3]].reshape(H, -1)), W, H, 32, 3,
                        masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)), rgba
    if form == "16-bit RGBA":
        low = np.random.default_rng(seed).integers(0, 256, rgba.shape)
        return png_form((rgba.astype(np.int64) << 8) | low, 16, 6), rgba
    if form == "32-bit RLE TGA with alpha":
        return tga_form(rgba, 10, 0x20), rgba
    if form == "16-bit planar RGBA TIFF":  # deflate planes with Predictor 2, as GDAL's INTERLEAVE=BAND
        return tiff_form(wide_samples(rgba), 16, 8, 2, 32, planar=True), rgba
    if form == "16-bit P6":  # low bits under half a step: PIL's rounding gives the colour back
        rgb = rgba[..., :3]
        low = np.random.default_rng(seed).integers(0, 128, rgb.shape)
        return ppm_form(b"P6", rgb.astype(np.int64) * 257 + np.where(rgb < 255, low, -low), 65535), opaque(rgb)
    if form == "palette + tRNS":  # 4 levels per channel and alpha: 256 entries
        q = rgba >> 6
        index = (q[..., 0] << 6) | (q[..., 1] << 4) | (q[..., 2] << 2) | q[..., 3]
        levels = np.arange(256)
        entries = np.stack([(levels >> 6) & 3, (levels >> 4) & 3, (levels >> 2) & 3, levels & 3], -1) * 85
        data = png_form(index[..., None], 8, 3, plte=entries[:, :3].astype(np.uint8).tobytes(),
                        trns=entries[:, 3].astype(np.uint8).tobytes())
        return data, (q * 85).astype(np.uint8)
    if form == "Adam7 RGBA":
        return png_form(rgba, 8, 6, interlace=True), rgba
    if form == "palette + alpha TIFF":  # 6 levels per channel in a 256-entry palette, alpha its own sample
        return palette_alpha_tiff(rgba)
    if form == "palette GIF + transparency":  # 4 levels per channel; alpha < 128 the transparent entry 64
        q = rgba[..., :3] >> 6
        index = np.where(rgba[..., 3] >= 128, (q[..., 0] << 4) | (q[..., 1] << 2) | q[..., 2], 64)
        levels = np.arange(64)
        entries = np.zeros((128, 3), np.int64)
        entries[:64] = np.stack([(levels >> 4) & 3, (levels >> 2) & 3, levels & 3], -1) * 85
        want = np.concatenate([entries[index], np.where(index == 64, 0, 255)[..., None]], -1)
        return gif_form(index.astype(np.uint8), entries, transparency=64, interlace=True), want.astype(np.uint8)
    if form == "grey + alpha":
        lum = ((rgba[..., :3].astype(np.int64) * [299, 587, 114]).sum(-1) + 500) // 1000
        la = np.stack([lum, rgba[..., 3]], -1)
        return png_form(la, 8, 4), np.concatenate([la[..., :1].repeat(3, -1), la[..., 1:]], -1).astype(np.uint8)
    # RGB + tRNS colour: the background black, which the tRNS chunk makes clear
    rgb = np.where(rgba[..., 3:] >= 128, rgba[..., :3], 0).astype(np.uint8)
    black = (rgb == 0).all(-1)
    rgb[black & (rgba[..., 3] >= 128)] = (0, 0, 1)
    alpha = np.where((rgb == 0).all(-1), 0, 255).astype(np.uint8)
    return png_form(rgb, 8, 2, trns=bytes(6)), np.concatenate([rgb, alpha[..., None]], -1)


def palette_alpha_tiff(rgba, rows_per_strip=16):
    """A little-endian palette + alpha TIFF (photometric 3, two 8-bit
    samples, ExtraSamples 2, PIL's mode PA) of an RGBA frame, deflate: each
    pixel's colour the nearest of 6 levels a channel (216 entries of a
    256-entry ColorMap, the rest grey), its alpha as written. Returns the
    file and the RGBA PIL's convert("RGBA") gives: the entry's colour (the
    ColorMap's high bytes) and the alpha."""
    H, W, _ = rgba.shape
    q = (rgba[..., :3].astype(np.int64) + 25) // 51
    index = q[..., 0] * 36 + q[..., 1] * 6 + q[..., 2]
    levels = np.arange(256)
    entries = np.where(levels[:, None] < 216, np.stack([levels // 36, levels // 6 % 6, levels % 6], -1) * 51,
                       levels[:, None] - 216).astype(np.int64)
    samples = np.stack([index, rgba[..., 3]], -1).astype(np.uint8)
    bodies = [zlib.compress(samples[y:y + rows_per_strip].tobytes(), 6) for y in range(0, H, rows_per_strip)]
    cmap = (entries.T.reshape(-1) * 257).tolist()
    tags = [(256, 4, [W]), (257, 4, [H]), (258, 3, [8, 8]), (259, 3, [8]), (262, 3, [3]),
            (273, 4, [0] * len(bodies)), (277, 3, [2]), (278, 3, [rows_per_strip]),
            (279, 4, [len(b) for b in bodies]), (320, 3, cmap), (338, 3, [2])]
    want = np.concatenate([entries[index], rgba[..., 3:]], -1).astype(np.uint8)
    return tiff_file(tags, bodies), want


def write_blender_dataset(data, dev):
    """nerf_synthetic/lego's layout at its width: renders of trained_r5 from
    an orbit at BLENDER_DIST (the scene scaled so its 95th-percentile radius
    is 1), alpha 1 - final T, the colour straight (C / alpha where alpha >=
    1/255, else 0). Returns {frame path: (form, the RGBA PIL would read)}."""
    model = load_gaussians_ply(TRAINED_PLY)
    center = model["xyz"].mean(axis=0)
    scale = float(np.quantile(np.linalg.norm(model["xyz"] - center, axis=1), 0.95))
    trained = params_from_ply(TRAINED_PLY)
    fov = math.degrees(BLENDER_ANGLE_X)
    views = BLENDER_TRAIN + BLENDER_TEST
    test_views = set(range(0, views, views // BLENDER_TEST))
    frames, expected = {"train": [], "test": []}, {}
    os.makedirs(os.path.join(data, "train"))
    os.makedirs(os.path.join(data, "test"))
    with torch.no_grad():
        acts = tuple(activate(trained))
        for i in range(views):
            cam = orbit_camera(center, BLENDER_DIST * scale, 2 * math.pi * (i + 0.5) / views,
                               BLENDER_W, BLENDER_W, fov, fov)
            arr = cam.arrays()
            n = int(preprocess(*acts, 3, arr, BLENDER_W, BLENDER_W, 32, 32).tiles_touched.sum())
            img, aux = eval_render(trained, arr, torch.zeros(3, device=dev), 3, BLENDER_W, BLENDER_W,
                                   RasterizerConfig(capacity_exact=entry_bucket_capacity(n, 16, 1.2)))
            alpha = 1.0 - aux["final_t"]
            straight = torch.where(alpha[..., None] >= 1 / 255, img / alpha.clamp_min(1 / 255)[..., None], 0.0)
            rgba = render_cli.quantize(torch.cat([straight, alpha[..., None]], -1).cpu().numpy())
            split = "test" if i in test_views else "train"
            k = len(frames[split])
            form = BLENDER_FORMS.get(k) if split == "train" else None
            path = os.path.join(data, split, f"r_{k}.png")
            body, want = blender_frame(rgba, form, seed=i)
            if body is None:
                image_io.write_png(path, rgba)
            else:
                with open(path, "wb") as f:
                    f.write(body)
            expected[path] = (form or "8-bit RGBA", want)
            c2w = np.eye(4)
            c2w[:3, :3] = cam.R
            c2w[:3, 3] = (-cam.R @ cam.T - center) / scale
            c2w[:3, 1:3] *= -1  # COLMAP (y down, z forward) -> Blender / OpenGL
            frames[split].append({"file_path": f"./{split}/r_{k}", "rotation": 2 * math.pi / views,
                                  "transform_matrix": c2w.tolist()})
    for split in ("train", "test"):
        with open(os.path.join(data, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": BLENDER_ANGLE_X, "frames": frames[split]}, f, indent=1)
    return expected


def blender_phase(dev):
    """Phase 5e: the NeRF-synthetic user's path. Returns the compositing
    kernels' launches in its train and render CLIs together, and the max
    abs errors of check_state at the train CLI's final state."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_blender_")
    try:
        return _blender_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _blender_phase(dev, tmp):
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    data, model_dir = os.path.join(tmp, "lego"), os.path.join(tmp, "model")
    expected = write_blender_dataset(data, dev)

    # Every frame as the reader returns it, held to PIL's rules.
    read_ms = {}
    for path, (form, want) in expected.items():
        if form == "CMYK JPEG":  # lossy: PIL's cmyk2rgb of what the decoder gives, close to the written CMYK
            pic, ms = synced_ms(image_io.open_image, path)
            mse = float(np.mean((pic.pixels.astype(np.float64) - want) ** 2)) if pic.pixels.shape == want.shape \
                else math.inf
            psnr_ = 10 * math.log10(255 ** 2 / max(mse, 1e-12))
            if pic.mode != "CMYK" or not psnr_ >= 30.0 or not np.array_equal(image_io.to_rgba(pic),
                                                                             cmyk_to_rgba(pic.pixels)):
                fail(f"blender path: {path} ({form}) reads as {pic.mode}, {psnr_:.2f} dB PSNR from the CMYK "
                     f"written, or to_rgba is not PIL's cmyk2rgb")
            read_ms.setdefault(f"{form} ({psnr_:.2f} dB)", []).append(ms)
            continue
        if form in ("RGBA JPEG 2000", "RGBA HTJ2K", "RGBA JPEG 2000 Part 2"):
            got, ms = synced_ms(lambda p: image_io.to_rgba(image_io.open_image(p)), path)
            want = {"RGBA JPEG 2000": jp2_readings()[JP2_FRAME], "RGBA HTJ2K": ht_readings()[HT_FRAME],
                    "RGBA JPEG 2000 Part 2": part2_readings()[PART2_FRAME]}[form]
            if (list(got.shape), sha256_of(got)) != (want["shape"], want["rgba_sha256"]):
                fail(f"blender path: {path} ({form}) reads otherwise than PIL's committed RGBA")
            read_ms.setdefault(form, []).append(ms)
            continue
        got, ms = synced_ms(lambda p: image_io.to_rgba(image_io.open_image(p)), path)
        if not np.array_equal(got, want):
            fail(f"blender path: {path} ({form}) reads otherwise than PIL's rules give at "
                 f"{int((got != want).any(-1).sum())} pixels")
        read_ms.setdefault(form, []).append(ms)
    print(f"blender path: nerf_synthetic/lego's layout, {BLENDER_TRAIN} train and {BLENDER_TEST} test "
          f"frames of trained_r5 at {BLENDER_W}x{BLENDER_W} (camera_angle_x {BLENDER_ANGLE_X}); "
          f"every frame's open_image + to_rgba bit-equal to PIL's rules; ms per frame (host clock): "
          + ", ".join(f"{form} {np.median(ms):.1f}" for form, ms in read_ms.items()))

    # Train from the default 100,000 random points.
    os.environ.pop("GS_TPU_BLENDER_INIT_POINTS", None)
    np.random.seed(0)
    reset_launches()
    scene, tr, train_s, load_s, _ = run_train_cli(["-s", data, "-m", model_dir, *BLENDER_FLAGS])
    train_launches = {k: LAUNCH_COUNTERS[k].launches for k in TRAIN_KERNELS}
    reports = len(BLENDER_REPORTS) * (BLENDER_TEST + 5)  # each report: the test views and 5 train views
    want = {"composite_fwd": BLENDER_STEPS + reports, "composite_bwd": BLENDER_STEPS,
            "route_grads": BLENDER_STEPS}
    if train_launches != want:
        fail(f"blender path: train CLI launches {train_launches}, the schedule gives {want}")
    step_ms = [h["iter_time_ms"] for h in tr.history]
    losses_ = [h["loss"] for h in tr.history]
    first20, last20 = float(np.mean(losses_[:20])), float(np.mean(losses_[-20:]))
    if tr.iteration != BLENDER_STEPS or not all(math.isfinite(x) for x in losses_) or not last20 < first20:
        fail(f"blender path: the run stopped at {tr.iteration} or the loss did not fall "
             f"(first 20 {first20}, last 20 {last20})")
    init = load_point_cloud_ply(os.path.join(data, "points3d.ply"))[0]
    if init.shape != (100_000, 3) or float(np.abs(init).max()) > 1.3 + 1e-6:
        fail(f"blender path: the init cloud is {init.shape}, max |x| {np.abs(init).max()}")
    if not (white := bool(torch.equal(tr.background.cpu(), torch.ones(3)))):
        fail(f"blender path: the trainer's background is {tr.background}, not white")
    pts = torch.from_numpy(init).to(dev)
    knn_ms = cuda_time_ms(lambda: mean_knn_dist2_morton(pts), 5)
    print(f"  train CLI: {BLENDER_STEPS} steps from {len(init)} random points in [-1.3, 1.3]^3, white "
          f"background {white}, wall {train_s:.2f} s (scene load {load_s:.2f} s: "
          f"{BLENDER_TRAIN + BLENDER_TEST} frames decoded (PNG, a CMYK JPEG, a BMP, a GIF, a TGA, a P6, a planar "
          f"TIFF, a JPEG 2000, an HTJ2K JP2, a Part 2 JP2, a palette + alpha TIFF) and "
          f"composited), step median "
          f"{np.median(step_ms):.3f} ms, p80 {np.percentile(step_ms, 80):.3f} ms (its iter_time_ms, "
          f"host clock); loss first 20 {first20:.6f}, last 20 {last20:.6f}; "
          f"{len(tr.densify_history)} densifies; live {tr.num_live}; launches {train_launches}")
    print(f"  Morton KNN at {len(init)} points: {knn_ms:.3f} ms (CUDA events)")

    # The three train-path kernels at this run's final state (grown from
    # the random cloud, then pruned), a test camera at 800x800 and the white
    # background, by phase 3's rules; their launches are not the path's
    # (the counters are reset before the render CLI).
    test_view = scene.get_test_cameras()[0]
    if (test_view.width, test_view.height) != (BLENDER_W, BLENDER_W):
        fail(f"blender path: a test camera of {test_view.width}x{test_view.height}")
    errs = check_trainer_state("blender train CLI final state", tr, test_view, 47)
    del scene, tr, pts

    # Render both splits, then the metrics.
    reset_launches()
    _, render_ms = synced_ms(in_process, render_cli.main, ["-m", model_dir])
    render_launches = {k: LAUNCH_COUNTERS[k].launches for k in TRAIN_KERNELS}
    views = BLENDER_TRAIN + BLENDER_TEST
    if render_launches != {"composite_fwd": views, "composite_bwd": 0, "route_grads": 0}:
        fail(f"blender path: render CLI launches {render_launches} for {views} views")
    corners = []
    for split, n in (("train", BLENDER_TRAIN), ("test", BLENDER_TEST)):
        out = render_cli_dir(model_dir, split, f"ours_{BLENDER_STEPS}", n)
        for i in range(n):
            r = image_io.read_png(os.path.join(out, "renders", f"{i:05d}.png"))
            patches = [r[:8, :8], r[:8, -8:], r[-8:, :8], r[-8:, -8:]]
            corners.append(min(float(p.mean()) for p in patches) / 255)
    if min(corners) < 0.8:
        fail(f"blender path: a render's background corner averages {min(corners):.3f}, not white")
    _, metrics_ms = synced_ms(in_process, metrics_cli.main, ["-m", model_dir])
    with open(os.path.join(model_dir, "results.json")) as f:
        result = json.load(f).get(f"ours_{BLENDER_STEPS}", {})
    if not all(math.isfinite(result.get(k) or math.nan) for k in ("SSIM", "PSNR", "LPIPS")):
        fail(f"blender path: results.json holds {result}")
    print(f"  render CLI: {views} views in {render_ms / 1e3:.2f} s wall, {render_ms / views:.1f} ms per "
          f"view; launches {render_launches}; every PNG written; render corners (8x8, darkest of four) "
          f"{min(corners):.3f}-{max(corners):.3f} of white")
    print(f"  metrics CLI: {metrics_ms:.1f} ms; test SSIM {result['SSIM']:.6f}, PSNR {result['PSNR']:.4f} dB, "
          f"LPIPS (vgg, seeded random weights) {result['LPIPS']:.6f}")
    print(f"  phase peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
          f"wall {time.perf_counter() - t_phase:.1f} s")
    return {k: train_launches[k] + render_launches[k] for k in TRAIN_KERNELS}, errs


# ---- phase 5g: the user's commands ------------------------------------------

# A COLMAP dataset frozen from PR to PR, so that the phase's numbers compare:
# USER_VIEWS views of trained_r5 on phase 5c's orbit at 1957x1091, the size of
# Tanks and Temples' truck views in the 3DGS authors' tandt_db release, each
# a baseline 4:2:0 JPEG at q95 (encode_jpeg). No other image form enters it.
USER_VIEWS, USER_W, USER_H = 12, 1957, 1091
USER_CAM = (1600, 891)  # the train CLI's default -r -1: a view wider than 1600 px scaled to 1600 wide
VIEWER_WIDE = (1920, 1080)  # a viewer window larger than the training views
USER_VIEWER_VIEW = 1  # the viewer's pose: a train view (llffhold 8 holds out views 0 and 8)
USER_STEPS, USER_CHECKPOINT, USER_PROFILE_AT, USER_DEBUG_FROM = 120, 60, 30, 110
# the symbols of the three train-path kernels, as a CUDA trace names them
TRACE_KERNELS = ("composite_fwd_kernel", "composite_bwd_kernel", "route_grads_kernel")


def user_flags():
    """Run A's flags after -s, -m and --port: the train CLI at its defaults
    (no -r, the viewer on) with reports, saves and a checkpoint, a random
    background, a profiled window, and phase 5c's densify and reset window
    (20 / 20 / 160 / 120 at 200 steps) scaled to USER_STEPS; run B's after
    -s and -m: a resume from run A's checkpoint under anomaly detection."""
    run_a = ["--eval", "--iterations", str(USER_STEPS),
             "--test_iterations", str(USER_CHECKPOINT), str(USER_STEPS),
             "--save_iterations", str(USER_CHECKPOINT), str(USER_STEPS),
             "--checkpoint_iterations", str(USER_CHECKPOINT), "--random_background",
             "--profile_iteration", str(USER_PROFILE_AT), "--densify_from_iter", "20",
             "--densification_interval", "20", "--densify_until_iter", "100",
             "--opacity_reset_interval", "80"]
    run_b = ["--iterations", str(USER_STEPS), "--debug_from", str(USER_DEBUG_FROM),
             "--detect_anomaly", "--disable_viewer"]
    return run_a, run_b


def viewer_request(cam, train=False, scaling_modifier=1.0, shs_python=False, rot_scale_python=False,
                   keep_alive=True) -> bytes:
    """The reference viewer's request for the Camera `cam`
    (network_gui.py:43-55): length-prefixed JSON, its matrices in the
    wire's transposed layout with the Y / Z flips `receive` undoes."""
    wv = np.asarray(cam.world_view_transform, np.float32).copy()
    wv[1:3] *= -1
    fp = np.asarray(cam.full_proj_transform, np.float32).copy()
    fp[1] *= -1
    payload = json.dumps(dict(
        resolution_x=cam.width, resolution_y=cam.height, train=train, fov_y=cam.fovy, fov_x=cam.fovx,
        z_near=cam.znear, z_far=cam.zfar, shs_python=shs_python, rot_scale_python=rot_scale_python,
        keep_alive=keep_alive, scaling_modifier=scaling_modifier,
        view_matrix=wv.T.reshape(-1).tolist(), view_projection_matrix=fp.T.reshape(-1).tolist(),
    )).encode("utf-8")
    return len(payload).to_bytes(4, "little") + payload


class ViewerClient:
    """A loopback client of the reference viewer's wire protocol: this
    script's own copy, as tests/test_viewer.py's sits under the JAX
    package's conftest. It connects as soon as the listener on `port`
    exists."""

    def __init__(self, port, wait_s=300.0):
        deadline = time.perf_counter() + wait_s
        while True:
            try:
                self.sock = socket.create_connection(("127.0.0.1", port), timeout=wait_s)
                return
            except ConnectionRefusedError:
                if time.perf_counter() > deadline:
                    raise
                time.sleep(0.02)

    def _read(self, n):
        buf = bytearray()
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("the viewer bridge closed the connection")
            buf += chunk
        return bytes(buf)

    def frame(self, cam, **kw):
        """One request and its reply: (the (H, W, 3) uint8 frame, the source
        path, the round trip's ms on the host clock)."""
        t0 = time.perf_counter()
        self.sock.sendall(viewer_request(cam, **kw))
        img = np.frombuffer(self._read(cam.width * cam.height * 3), np.uint8)
        path = self._read(int.from_bytes(self._read(4), "little")).decode("ascii")
        return img.reshape(cam.height, cam.width, 3), path, (time.perf_counter() - t0) * 1e3

    def close(self):
        self.sock.close()


def viewer_session(port, small, wide, out):
    """Run A's viewer, on a thread: a request with `train` that the loop
    answers before step 1 and then trains on; between two steps the plain
    `small` frame twice, the `wide` frame at scaling modifier 1 and 0.5 and
    with both SIBR toggles, then `train` again, after which training goes
    on; the connection closed; last a second client that sends half a
    request and closes. Every client sends at once: a connected client that
    sends nothing holds the loop in `receive`, in the reference too."""
    try:
        client = ViewerClient(port)
        out["first"] = client.frame(small, train=True)
        out["small"] = [client.frame(small), client.frame(small)]
        out["wide"] = client.frame(wide)
        out["half"] = client.frame(wide, scaling_modifier=0.5)
        out["toggled"] = client.frame(wide, shs_python=True, rot_scale_python=True)
        out["last"] = client.frame(small, train=True)
        client.close()
        client = ViewerClient(port)
        msg = viewer_request(small)
        client.sock.sendall(msg[:len(msg) // 2])
        client.close()
        out["done"] = True
    except Exception as e:  # the main thread reads it and fails the phase
        out["error"] = repr(e)


class ViewerProbe:
    """While patched (`with`): the viewer bridge that the train CLI starts
    (`viewer/network_gui.py`) records each connection it takes and drops,
    at the trainer's iteration, and each frame it serves: iteration, size,
    options, entry count against the entry capacity, and `eval_render`'s
    ms (host clock, between two device waits)."""

    def __enter__(self):
        self.cls, self.render = network_gui.NetworkGUI, network_gui.eval_render
        self.guis, self.frames, self.events = [], [], []
        self.iteration, self.open = None, False
        probe = self

        def render(params, cam, bg, sh, width, height, cfg, **kw):
            (img, aux), ms = synced_ms(lambda: probe.render(params, cam, bg, sh, width, height, cfg, **kw))
            probe.frames.append(dict(iteration=probe.iteration, size=(width, height), ms=ms,
                                     entries=int(aux["num_entries"]),
                                     capacity=cfg.capacity(params.num_points), **kw))
            return img, aux

        class Recording(self.cls):
            def __init__(gui, *args, **kw):
                super().__init__(*args, **kw)
                probe.guis.append(gui)

            def try_connect(gui):
                super().try_connect()
                if gui.conn is not None and not probe.open:
                    probe.open = True
                    probe.events.append(("taken", probe.iteration))

            def poll(gui, trainer):
                probe.iteration = trainer.iteration
                super().poll(trainer)
                if gui.conn is None and probe.open:
                    probe.open = False
                    probe.events.append(("dropped", probe.iteration))

        network_gui.NetworkGUI, network_gui.eval_render = Recording, render
        return self

    def __exit__(self, *exc):
        network_gui.NetworkGUI, network_gui.eval_render = self.cls, self.render
        for gui in self.guis:
            gui.listener.close()


class TrainerProbe:
    """While patched (`with`): each `train_step` of the trainer loop is
    recorded as (iteration, the entry capacity it ran at, its entry count),
    and the state a `Trainer.load_checkpoint` leaves is copied to the host
    with its device."""

    def __enter__(self):
        self.step_fn, self.load_fn = trainer_mod.train_step, Trainer.load_checkpoint
        self.steps, self.loaded = [], None
        probe = self

        def step(state, cam, gt, bg, it, **kw):
            m = probe.step_fn(state, cam, gt, bg, it, **kw)
            probe.steps.append((it, kw["raster_cfg"].capacity(state.params.num_points), m["num_entries"]))
            return m

        def load(trainer, path):
            probe.load_fn(trainer, path)
            probe.loaded = dict(device=trainer.state.params.xyz.device, iteration=trainer.iteration,
                                host=_state_to_host(trainer.state))

        trainer_mod.train_step, Trainer.load_checkpoint = step, load
        return self

    def __exit__(self, *exc):
        trainer_mod.train_step, Trainer.load_checkpoint = self.step_fn, self.load_fn

    def overflows(self):
        """The recorded steps whose entry count exceeded their capacity."""
        return [(it, cap, int(n)) for it, cap, n in self.steps if int(n) > cap]


def lit(img):
    return int((img.astype(np.int64).sum(-1) > 0).sum())


def user_phase(dev):
    """Phase 5g (module docstring). Returns the compositing kernels'
    launches in the train CLI runs (the viewer's frames included) and in
    the render CLI runs, and the max abs errors of the forward, the
    backward and the routing against their plain versions at run A's final
    state."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_user_")
    try:
        return _user_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _user_phase(dev, tmp):
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    data, model_a, model_b = (os.path.join(tmp, d) for d in ("data", "A", "B"))
    run_a, run_b = user_flags()
    n_test = len(range(0, USER_VIEWS, 8))  # llffhold=8
    bg0 = torch.zeros(3, device=dev)

    # The dataset: every view a JPEG.
    t0 = time.perf_counter()
    model = load_gaussians_ply(TRAINED_PLY)
    cams, images = orbit_dataset(USER_VIEWS, USER_W, USER_H)
    write_colmap_scene(data, cams, images, model["xyz"], dc_colors(model))
    with ThreadPoolExecutor(4) as pool:  # numpy lets go of the interpreter lock in the DCT and packing
        bodies = list(pool.map(lambda px: encode_jpeg(px, CLI_JPEG_QUALITY, (2, 2)), images))
    files = {cam.image_name: f"{cam.image_name}.jpg" for cam in cams}
    for cam, body in zip(cams, bodies):
        os.remove(os.path.join(data, "images", f"{cam.image_name}.png"))
        with open(os.path.join(data, "images", files[cam.image_name]), "wb") as f:
            f.write(body)
    rename_views(data, files)
    print(f"user path: a COLMAP dataset of {USER_VIEWS} views of trained_r5 at {USER_W}x{USER_H} (Tanks and "
          f"Temples truck's size), each a baseline 4:2:0 JPEG q{CLI_JPEG_QUALITY}, made in "
          f"{time.perf_counter() - t0:.1f} s")

    # Run A: the train CLI as a user starts it, the viewer on.
    pose = cams[USER_VIEWER_VIEW]

    def view_at(size):
        return Camera(uid=0, colmap_id=0, R=pose.R, T=pose.T, fovx=pose.fovx, fovy=pose.fovy, image=None,
                      image_name=pose.image_name, width=size[0], height=size[1])

    small, wide = view_at(USER_CAM), view_at(VIEWER_WIDE)
    port = free_port()
    replies = {}
    client = threading.Thread(target=viewer_session, args=(port, small, wide, replies), daemon=True)
    reset_launches()
    with ViewerProbe() as viewer, TrainerProbe() as probe_a:
        client.start()
        scene, tr, train_s, load_s, panel_ms = run_train_cli(["-s", data, "-m", model_a, "--port", str(port),
                                                               *run_a])
    launches_a = {k: LAUNCH_COUNTERS[k].launches for k in TRAIN_KERNELS}
    client.join(timeout=60)
    if client.is_alive() or "error" in replies or not replies.get("done"):
        fail(f"user path: the viewer client did not finish: {replies.get('error', 'still running')}")
    if tr.iteration != USER_STEPS or [h["iteration"] for h in tr.history] != list(range(1, USER_STEPS + 1)):
        fail(f"user path: run A stopped at iteration {tr.iteration}")
    views = scene.get_train_cameras() + scene.get_test_cameras()
    sizes = sorted({(c.width, c.height) for c in views})
    if sizes != [USER_CAM] or len(views) != USER_VIEWS or len(scene.get_test_cameras()) != n_test:
        fail(f"user path: the train CLI's cameras are {sizes}, {len(views)} views, not {USER_VIEWS} at {USER_CAM}")
    with open(os.path.join(model_a, "cameras.json")) as f:
        listed = sorted({(c["width"], c["height"]) for c in json.load(f)})
    if listed != [(USER_W, USER_H)]:  # the dataset's size, as the JAX CLI and the reference write it
        fail(f"user path: cameras.json lists sizes {listed}, not the dataset's {USER_W}x{USER_H}")
    view = scene.get_train_cameras()[0]
    px, decode_ms = synced_ms(image_io.read_image, os.path.join(data, "images", files[view.image_name]))
    small_px, resize_ms = synced_ms(image_io.resize, px, USER_CAM)
    if not np.array_equal(view.image, np.clip(small_px.astype(np.float32) / 255.0, 0.0, 1.0).transpose(2, 0, 1)):
        fail(f"user path: {view.image_name}'s ground truth is not image_io.resize of its JPEG")
    reports = 2 * (n_test + 5)  # each report: the test views and 5 train views
    want = {"composite_fwd": USER_STEPS + reports + len(viewer.frames), "composite_bwd": USER_STEPS,
            "route_grads": USER_STEPS}
    if launches_a != want:
        fail(f"user path: run A launches {launches_a}, the schedule gives {want}")
    # the opacity reset (at 80 of 120) sets the loss back: the 20 steps
    # before it are held below the first 20
    losses_ = [h["loss"] for h in tr.history]
    reset_at = int(run_a[run_a.index("--opacity_reset_interval") + 1])
    first20, before_reset, last20 = (float(np.mean(losses_[i:i + 20]))
                                     for i in (0, reset_at - 20, len(losses_) - 20))
    if not all(math.isfinite(x) for x in losses_) or not before_reset < first20 or not tr.densify_history:
        fail(f"user path: run A's loss first 20 {first20}, 20 before the reset {before_reset}, "
             f"{len(tr.densify_history)} densifies")
    for f in ("cfg_args", "input.ply", f"chkpnt{USER_CHECKPOINT}.pth",
              *(f"point_cloud/iteration_{i}/point_cloud.ply" for i in (USER_CHECKPOINT, USER_STEPS))):
        if not os.path.exists(os.path.join(model_a, f)):
            fail(f"user path: run A wrote no {f}")
    step_a = [h["iter_time_ms"] for h in tr.history]
    print(f"  run A (train CLI, -r -1, viewer on, --random_background, --profile_iteration {USER_PROFILE_AT}): "
          f"{USER_STEPS} steps, {USER_VIEWS - n_test} train and {n_test} test views at "
          f"{USER_CAM[0]}x{USER_CAM[1]} (cameras.json: the dataset's {USER_W}x{USER_H}), wall {train_s:.2f} s "
          f"(scene load {load_s:.2f} s; tensorboard panels {sum(panel_ms):.0f} ms in {len(panel_ms)}), step "
          f"median {np.median(step_a):.3f} ms, p80 {np.percentile(step_a, 80):.3f} ms (iter_time_ms, host "
          f"clock); loss first 20 {first20:.6f}, 20 before the reset at {reset_at} {before_reset:.6f}, last "
          f"20 {last20:.6f}; {len(tr.densify_history)} densifies "
          f"({[d['path'] for d in tr.densify_history]}), live {tr.num_live}; launches {launches_a}")
    print(f"  {view.image_name}: JPEG decode {decode_ms:.1f} ms, resize {USER_W}x{USER_H} -> "
          f"{USER_CAM[0]}x{USER_CAM[1]} {resize_ms:.1f} ms; its ground truth bit-equal to that resize")
    over_a = probe_a.overflows()
    print(f"  run A: steps over their entry capacity {over_a} (the trainer grows it at once)")

    # The profiler's CUDA trace of steps USER_PROFILE_AT to + 5.
    trace = os.path.join(model_a, "profile", f"trace_{USER_PROFILE_AT}.json")
    if not os.path.exists(trace):
        fail(f"user path: run A wrote no {trace}")
    with open(trace) as f:
        text = f.read()
    named = {k: text.count(k) for k in TRACE_KERNELS}
    if not all(named.values()):
        fail(f"user path: the profiler trace names the kernels {named}")
    print(f"  torch.profiler trace of steps {USER_PROFILE_AT}-{USER_PROFILE_AT + 5}: {len(text) / 2**20:.1f} MiB, "
          f"kernel names seen {named}")

    # The viewer during run A.
    events = viewer.events
    if [e for e, _ in events] != ["taken", "dropped", "taken", "dropped"] or max(i for _, i in events) >= USER_STEPS:
        fail(f"user path: the viewer's connections {events}")
    its = [fr["iteration"] for fr in viewer.frames]
    if len(its) != 7 or its[1:] != [its[0] + 1] * 6 or its[-1] >= USER_STEPS - 1:
        fail(f"user path: the viewer served {[(fr['iteration'], fr['size']) for fr in viewer.frames]}")
    (a, path, ms_a), (b, _, ms_b) = replies["small"]
    wide_img, _, ms_wide = replies["wide"]
    half_img, toggled = replies["half"][0], replies["toggled"][0]
    if path != data or any(r[1] != data for r in (replies["first"], replies["last"])):
        fail(f"user path: the viewer names the source {path!r}, not {data!r}")
    if not np.array_equal(a, b) or lit(a) == 0:
        fail(f"user path: two frames of one state differ or are black ({lit(a)} pixels lit)")
    if not lit(half_img) < lit(wide_img):
        fail(f"user path: scaling modifier 0.5 lit {lit(half_img)} pixels, 1.0 {lit(wide_img)}")
    tog_diff = int(np.abs(toggled.astype(int) - wide_img.astype(int)).max())
    if tog_diff > 1:
        fail(f"user path: the SIBR toggles' frame differs from the plain one by {tog_diff} levels")
    served = {(fr["size"], fr.get("scale_modifier", 1.0), fr.get("shs_python", False)): fr
              for fr in viewer.frames}
    big = served[(VIEWER_WIDE, 1.0, False)]
    print(f"  viewer during run A: connections {events}; {len(viewer.frames)} frames served, then training "
          f"went on to {USER_STEPS}; {USER_CAM[0]}x{USER_CAM[1]} twice bit-equal ({lit(a)} pixels lit), "
          f"round trip {ms_a:.1f} / {ms_b:.1f} ms; {VIEWER_WIDE[0]}x{VIEWER_WIDE[1]} {ms_wide:.1f} ms "
          f"({lit(wide_img)} lit), at scaling modifier 0.5 {lit(half_img)} lit, with both SIBR toggles "
          f"within {tog_diff} level of the plain frame; eval_render ms: "
          + ", ".join(f"{fr['size'][0]}x{fr['size'][1]} {fr['ms']:.1f}" for fr in viewer.frames))
    print(f"  viewer at the trainer's raster_cfg: {VIEWER_WIDE[0]}x{VIEWER_WIDE[1]} total {big['entries']} "
          f"entries against capacity {big['capacity']} ({'OVERFLOW: whole Gaussians dropped' if big['entries'] > big['capacity'] else 'fits'}); "
          f"{USER_CAM[0]}x{USER_CAM[1]} {served[(USER_CAM, 1.0, False)]['entries']} entries")

    # The three train-path kernels at run A's final state and a test view.
    errs = check_trainer_state("run A final state", tr, scene.get_test_cameras()[0], 47)

    # The trainer, served through a fresh bridge on an ephemeral port: each
    # frame within one uint8 level of eval_render on the same camera.
    gui = network_gui.NetworkGUI(port=0)
    gui.source_path = data
    settings = (("plain", small, {}), ("wide", wide, {}), ("half", wide, {"scaling_modifier": 0.5}),
                ("toggled", wide, {"shs_python": True, "rot_scale_python": True}))
    got = {}

    def session():
        try:
            c = ViewerClient(gui.listener.getsockname()[1], wait_s=60.0)
            for key, cam, kw in settings:
                got[key] = c.frame(cam, **kw)
            c.close()
        except Exception as e:
            got["error"] = repr(e)

    thread = threading.Thread(target=session, daemon=True)
    thread.start()
    deadline = time.perf_counter() + 60
    while gui.conn is None and time.perf_counter() < deadline:
        gui.try_connect()
        time.sleep(0.01)
    gui.poll(tr)
    thread.join(timeout=60)
    gui.listener.close()
    if thread.is_alive() or "error" in got or len(got) != len(settings):
        fail(f"user path: the fresh viewer served {sorted(got)}: {got.get('error')}")
    diffs = {}
    for key, cam, kw in settings:
        img, _ = eval_render(tr.state.params, cam.arrays(device=dev), tr.background, tr.active_sh_degree,
                             cam.width, cam.height, tr.raster_cfg, scale_modifier=kw.get("scaling_modifier", 1.0),
                             shs_python=kw.get("shs_python", False),
                             rot_scale_python=kw.get("rot_scale_python", False))
        direct = (torch.clamp(img, 0, 1) * 255).to(torch.uint8).cpu().numpy()
        diffs[key] = int(np.abs(direct.astype(int) - got[key][0].astype(int)).max())
    if max(diffs.values()) > 1 or any(got[k][1] != data for k in diffs):
        fail(f"user path: the fresh viewer's frames differ from eval_render by {diffs} levels")
    print(f"  fresh viewer on run A's trainer (iteration {tr.iteration}): frames vs eval_render on the same "
          f"camera, max level difference {diffs}; round trip "
          + ", ".join(f"{k} {got[k][2]:.1f} ms" for k in diffs))
    busy = device_busy_ms(lambda: tr.step(), reps=3)
    print_busy(*busy, float(np.median(step_a)), f"{USER_CAM[0]}x{USER_CAM[1]} trainer step")
    del scene, tr

    # Run B: a resume from run A's checkpoint under anomaly detection.
    ckpt = os.path.join(model_a, f"chkpnt{USER_CHECKPOINT}.pth")
    with open(ckpt, "rb") as f:
        payload = pickle.load(f)
    reset_launches()
    with TrainerProbe() as probe_b:
        scene_b, tr_b, train_b_s, load_b_s, _ = run_train_cli(["-s", data, "-m", model_b, "--start_checkpoint",
                                                               ckpt, *run_b])
    launches_b = {k: LAUNCH_COUNTERS[k].launches for k in TRAIN_KERNELS}
    steps_b = USER_STEPS - USER_CHECKPOINT
    if [h["iteration"] for h in tr_b.history] != list(range(USER_CHECKPOINT + 1, USER_STEPS + 1)):
        fail(f"user path: run B's iterations {[h['iteration'] for h in tr_b.history][:3]}..., not "
             f"{USER_CHECKPOINT + 1} to {USER_STEPS}")
    loaded = probe_b.loaded
    if loaded is None or loaded["device"].type != dev.type or loaded["iteration"] != USER_CHECKPOINT:
        fail(f"user path: run B loaded no checkpoint onto the card ({loaded and loaded['device']})")
    params, m, v, stats, step = loaded["host"]
    saved = {"params": params, "adam_m": m, "adam_v": v, "stats": stats}
    unequal = [f"{part}.{k}" for part, rows in saved.items() for k, x in rows.items()
               if x.dtype != payload[part][k].dtype or not np.array_equal(x, payload[part][k])]
    if unequal or step != payload["adam_step"]:
        fail(f"user path: the state after the load differs from the checkpoint in {unequal}, step {step} "
             f"vs {payload['adam_step']}")
    over_b = probe_b.overflows()
    if over_b or probe_b.steps[0][0] != USER_CHECKPOINT + 1:
        fail(f"user path: run B's steps over their entry capacity {over_b}")
    if torch.is_anomaly_enabled():
        fail("user path: anomaly detection stayed on after the train CLI returned")
    if not tr_b.debug or launches_b != {k: steps_b for k in TRAIN_KERNELS}:
        fail(f"user path: run B's debug flag {tr_b.debug}, launches {launches_b}")
    final_b = load_gaussians_ply(os.path.join(model_b, f"point_cloud/iteration_{USER_STEPS}/point_cloud.ply"))
    if not all(np.isfinite(x).all() for x in final_b.values()):
        fail("user path: run B's final PLY is not finite")
    step_b = [h["iter_time_ms"] for h in tr_b.history]
    print(f"  run B (--start_checkpoint chkpnt{USER_CHECKPOINT}.pth, --detect_anomaly, --debug_from "
          f"{USER_DEBUG_FROM}): iterations {USER_CHECKPOINT + 1}-{USER_STEPS}, the loaded state ({len(params['xyz'])} "
          f"live rows, their Adam moments, step {step}, statistics) bit-equal to the checkpoint on the card; "
          f"capacity probed at step {USER_CHECKPOINT + 1}: {probe_b.steps[0][1]} for {int(probe_b.steps[0][2])} "
          f"entries, no step over it; wall {train_b_s:.2f} s (scene load {load_b_s:.2f} s), step median "
          f"{np.median(step_b):.3f} ms, p80 {np.percentile(step_b, 80):.3f} ms; no anomaly raised, anomaly "
          f"detection off again after; final PLY ({len(final_b['xyz'])} rows) finite; launches {launches_b}")
    del scene_b, tr_b

    # The render and metrics CLIs.
    reset_launches()
    _, render_a_ms = synced_ms(in_process, render_cli.main, ["-m", model_a, "--iteration", str(USER_CHECKPOINT),
                                                             "--skip_train"])
    _, render_b_ms = synced_ms(in_process, render_cli.main, ["-m", model_b, "--skip_test"])
    render_launches = {k: LAUNCH_COUNTERS[k].launches for k in TRAIN_KERNELS}
    if render_launches != {"composite_fwd": n_test + USER_VIEWS, "composite_bwd": 0, "route_grads": 0}:
        fail(f"user path: render CLI launches {render_launches}")
    if os.path.exists(os.path.join(model_a, "train")) or os.path.exists(os.path.join(model_b, "test")):
        fail("user path: the render CLI rendered a split it was told to skip")
    out_a = render_cli_dir(model_a, "test", f"ours_{USER_CHECKPOINT}", n_test)
    out_b = render_cli_dir(model_b, "train", f"ours_{USER_STEPS}", USER_VIEWS)
    pngs = [os.path.join(o, k, f"{i:05d}.png") for o, n in ((out_a, n_test), (out_b, USER_VIEWS))
            for k in ("renders", "gt") for i in range(n)]
    shapes = sorted({image_io.read_png(p).shape for p in pngs})
    if shapes != [(USER_CAM[1], USER_CAM[0], 3)]:
        fail(f"user path: the render CLI wrote PNGs of {shapes}")
    info = read_colmap_scene(data, None, eval_split=True)
    test_views = [load_camera(c, -1) for c in info.test_cameras]
    at_60 = params_from_ply(os.path.join(model_a, f"point_cloud/iteration_{USER_CHECKPOINT}/point_cloud.ply"),
                            device=dev)
    rcfg = RasterizerConfig(capacity_exact=render_cli.auto_capacity(at_60, test_views, RasterizerConfig(), 3))
    want_png = quantize(eval_render(at_60, test_views[0].arrays(device=dev), bg0, 3, *USER_CAM, rcfg)[0])
    render_diff = int(np.abs(image_io.read_png(os.path.join(out_a, "renders", "00000.png")).astype(int)
                             - want_png.astype(int)).max())
    if render_diff > 1:
        fail(f"user path: the render CLI's test view 0 differs from eval_render by {render_diff} levels")
    print(f"  render CLI: -m A --iteration {USER_CHECKPOINT} --skip_train {n_test} views in {render_a_ms:.0f} ms "
          f"({render_a_ms / n_test:.1f} ms a view), -m B --skip_test {USER_VIEWS} views in {render_b_ms:.0f} ms "
          f"({render_b_ms / USER_VIEWS:.1f} ms a view); every PNG {USER_CAM[0]}x{USER_CAM[1]}; test view 0 within "
          f"{render_diff} level of eval_render of point_cloud/iteration_{USER_CHECKPOINT}; launches {render_launches}")
    print(metrics_cli_line(model_a, f"ours_{USER_CHECKPOINT}", n_test, dev, "user path"))

    train_launches = {k: launches_a[k] + launches_b[k] for k in TRAIN_KERNELS}
    print(f"  phase peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
          f"wall {time.perf_counter() - t_phase:.1f} s")
    return train_launches, render_launches, errs


# ---- phase 5h: the legacy forms ---------------------------------------------

# PIL's reading of each 1080p file of `legacy_form_files` (its mode, shape,
# pixels' SHA-256) and the file's own SHA-256, as
# tests/fixtures/torch_legacy_forms/make_fixtures.py wrote them with PIL 12.1.0
LEGACY_FIXTURES = os.path.join(FIXTURES, "torch_legacy_forms")
LEGACY_STEPS = 30
LEGACY_VIEWS = ("DIB 24-bit", "QOI RGBA", "PCX RGB", "SGI RLE RGB 8-bit", "SGI RLE RGB 16-bit", "PSD RLE RGB",
                "DCX")
LEGACY_EXT = {"DIB": ".dib", "QOI": ".qoi", "PCX": ".pcx", "SGI": ".sgi", "PSD": ".psd", "DCX": ".dcx"}


def image_writers():
    """tests/torch_image_writers.py: the tests' writers of the forms PIL
    reads but does not write (standard library and numpy only), which the
    card's machine can import."""
    tests = os.path.join(ROOT, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_image_writers

    return torch_image_writers


def legacy_form_files(px=None, alpha=None, names=None):
    """The files of phase 5h in the forms of DIB, QOI, PCX, SGI, PSD, DCX and
    ICO, written by tests/torch_image_writers.py from `px` (default: the
    form picture at 1920x1080) and `alpha` (QOI's and the icons'; default
    a ramp of 128..255): {name: bytes}, of every form or of `names`.
    The icons are 256x256, the largest an ICO holds: one PNG entry, one
    32-bit BMP entry."""
    w = image_writers()
    px = form_picture() if px is None else px
    H, W = px.shape[:2]
    if alpha is None:
        yy, xx = np.mgrid[0:H, 0:W]
        alpha = (128 + (3 * xx + 5 * yy) % 128).astype(np.uint8)
    rgba = np.concatenate([px, alpha[..., None]], -1)
    icon = rgba[:256, :256]
    bgra = np.ascontiguousarray(icon[..., [2, 1, 0, 3]]).reshape(256, -1)

    def pcx_rgb():
        return w.pcx_bytes(w.pcx_lines(px, 8, 3, W + W % 2), W, H, 8, 3)

    writers = {
        "DIB 24-bit": lambda: w.dib_bytes(w.padded_rows(px[..., ::-1].reshape(H, -1)), W, H, 24),
        "QOI RGBA": lambda: w.qoi_bytes(rgba),
        "PCX RGB": pcx_rgb,
        "SGI RLE RGB 8-bit": lambda: w.sgi_bytes(px, 1, rle=True),
        "SGI RLE RGB 16-bit": lambda: w.sgi_bytes(wide_samples(px).astype(np.uint16), 2, rle=True),
        "PSD RLE RGB": lambda: w.psd_bytes(px.transpose(2, 0, 1), 3, compression=1),
        "DCX": lambda: w.dcx_bytes([pcx_rgb()]),
        "ICO 256x256 PNG entry": lambda: w.icon_bytes([(256, 256, 0, 32, w.png_bytes(icon))]),
        "ICO 256x256 32-bit BMP entry": lambda: w.icon_bytes([(256, 256, 0, 32, w.icon_dib(
            w.padded_rows(bgra), 256, 256, 32, and_mask=np.zeros((256, 256), np.uint8)))]),
    }
    return {name: write() for name, write in writers.items() if names is None or name in names}


def check_legacy_forms(tmp):
    """Phase 5h (a): each file of `legacy_form_files` the bytes PIL read
    (its SHA-256) and, through `image_io.open_image`, PIL's mode, shape
    and pixels' SHA-256 (tests/fixtures/torch_legacy_forms/sha256.json).
    Returns {name: (the port's median ms of 5 decodes, PIL's median of 3 or
    "not measured")}."""
    with open(os.path.join(LEGACY_FIXTURES, "sha256.json")) as f:
        readings = json.load(f)["chip_smoke"]
    made = legacy_form_files()
    if sorted(made) != sorted(readings):
        fail(f"legacy forms: this script makes {sorted(made)}, the fixture holds {sorted(readings)}")
    have_pil = importlib.util.find_spec("PIL") is not None
    times = {}
    for name, data in made.items():
        want = readings[name]
        if hashlib.sha256(data).hexdigest() != want["file_sha256"]:
            fail(f"legacy forms: the writers made other bytes for '{name}' than the file PIL read "
                 f"(tests/fixtures/torch_legacy_forms/sha256.json)")
        path = os.path.join(tmp, "form" + LEGACY_EXT.get(name.split()[0], ".ico"))
        with open(path, "wb") as f:
            f.write(data)
        ms, pil_ms = [], []
        for i in range(5):
            pic, t = synced_ms(image_io.open_image, path)
            ms.append(t)
            if have_pil and i < 3:  # PIL's QOI decoder is Python: seconds a 1080p file
                from PIL import Image

                t0 = time.perf_counter()
                with Image.open(path) as im:
                    np.asarray(im)
                pil_ms.append((time.perf_counter() - t0) * 1e3)
        digest = sha256_of(pic.pixels)
        if (pic.mode, list(pic.pixels.shape), digest) != (want["mode"], want["shape"], want["sha256"]):
            fail(f"legacy forms: {name} reads as {pic.mode} {pic.pixels.shape} with SHA-256 {digest}, not PIL's "
                 f"{want['mode']} {want['shape']} {want['sha256']}")
        times[name] = (float(np.median(ms)), f"{np.median(pil_ms):.2f}" if pil_ms else "not measured")
    return times


def legacy_phase(dev):
    """Phase 5h (module docstring). Returns the compositing kernels'
    launches in the train CLI run and the max abs errors of the forward,
    the backward and the routing against their plain versions at its final
    state."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_legacy_")
    try:
        return _legacy_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _legacy_phase(dev, tmp):
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # (a) The 1080p files and the icons, held to PIL's committed readings.
    times = check_legacy_forms(tmp)
    print(f"legacy forms: {len(times)} files of tests/torch_image_writers.py (1920x1080, the icons 256x256) "
          f"read with PIL 12.1.0's mode, shape and pixels (tests/fixtures/torch_legacy_forms/sha256.json); "
          f"decode ms, median of 5 (host clock), beside PIL's median of 3 on this machine ({pil_versions()}):")
    for name, (ms, pil_ms) in times.items():
        print(f"  {name}: {ms:.2f} ms (PIL {pil_ms})")

    # (b) A COLMAP dataset of trained_r5 whose views are seven of those forms.
    def write(i, cam, px, form, stem):
        write_file(stem + LEGACY_EXT[form.split()[0]],
                   legacy_form_files(px, np.full(px.shape[:2], 255, np.uint8), [form])[form])
        return os.path.basename(stem) + LEGACY_EXT[form.split()[0]]

    ds = form_dataset(tmp, LEGACY_VIEWS, write)
    by_name = {c.image_name: c for c in ds.cameras}
    for cam, px in zip(ds.cams, ds.images):
        pic = image_io.open_image(by_name[cam.image_name].image_path)
        if not np.array_equal(pic.pixels[..., :3], px):
            fail(f"legacy forms: view {ds.files[cam.image_name]} does not read back as its render")
    launches, errs, (train_s, load_s, step_ms, loss0, loss1) = train_cli_on(
        "legacy forms", ds.data, ds.model_dir, len(LEGACY_VIEWS), LEGACY_STEPS, 53)
    print(f"  train CLI on a COLMAP dataset of {len(LEGACY_VIEWS)} views of trained_r5 at {W_MAIN}x{H_MAIN}, one "
          f"each {', '.join(LEGACY_VIEWS)} (made in {ds.build_s:.1f} s): -r 1, {LEGACY_STEPS} iterations in "
          f"{train_s:.2f} s (scene load {load_s:.2f} s), step median {step_ms:.3f} ms; loss "
          f"{loss0:.6f} -> {loss1:.6f}; launches {launches}")
    print(f"  phase peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
          f"wall {time.perf_counter() - t_phase:.1f} s")
    return launches, errs


# ---- phase 5i: DDS ------------------------------------------------------------

# PIL's reading of each 1080p file of `dds_form_files` (its mode, shape,
# pixels' SHA-256) and the file's own SHA-256, as
# tests/fixtures/torch_dds/make_fixtures.py wrote them with PIL 12.1.0
DDS_FIXTURES = os.path.join(FIXTURES, "torch_dds")
DDS_STEPS = 30
DDS_VIEWS = ("DXT1", "DXT5", "DX10 BC1", "BC7", "BC6H UF16", "A8R8G8B8", "DX10 R8G8B8A8")
DDS_LOSSLESS = ("A8R8G8B8", "DX10 R8G8B8A8")
# forms PIL decodes with its Python DdsRgbDecoder (~10 s a 1080p file on a
# host core): PIL is timed once on the first, not on the others
DDS_PIL_PYTHON = ("A8R8G8B8", "X8R8G8B8", "R8G8B8 24-bit", "R5G6B5")


def dds_form_files(px=None, alpha=None, names=None, decoded=False):
    """The files of phase 5i, one DDS of each form PIL reads, written by
    tests/torch_image_writers.py from `px` (default: the form picture at
    1920x1080) and `alpha` (default a ramp of 128..255): {name: bytes}, of
    every form or of `names`; with `decoded`, {name: (bytes, the pixels the
    writer's blocks decode to, or None for a form not block-coded)}."""
    w = image_writers()
    px = form_picture() if px is None else px
    H, W = px.shape[:2]
    if alpha is None:
        yy, xx = np.mgrid[0:H, 0:W]
        alpha = (128 + (3 * xx + 5 * yy) % 128).astype(np.uint8)
    rgba = np.concatenate([px, alpha[..., None]], -1)
    grey = ((px.astype(np.int64) * np.array([299, 587, 114])).sum(-1) // 1000).astype(np.uint8)
    half = (np.arange(256, dtype=np.float32) / 255).astype(np.float16).view(np.uint16)[px]
    i = np.arange(256)
    palette = np.stack([(i >> 5) * 255 // 7, ((i >> 2) & 7) * 255 // 7, (i & 3) * 85, 128 + i // 2], -1)
    index = (px[..., 0] >> 5) << 5 | (px[..., 1] >> 5) << 2 | px[..., 2] >> 6
    argb, F, A = (0xFF0000, 0xFF00, 0xFF, 0xFF000000), w.DDPF_FOURCC, w.DDPF_ALPHAPIXELS

    def masked(image, bits, masks, flags):
        return w.dds_bytes(w.dds_masked(image, bits, masks), W, H, flags, bitcount=bits,
                           masks=tuple(masks) + (0,) * (4 - len(masks))), None

    def blocks(encode, image, **header):
        body, out = encode(image, decoded=True)
        return w.dds_bytes(body.tobytes(), W, H, F, **header), out

    def plain(body, flags, bits=0, **header):
        return w.dds_bytes(np.ascontiguousarray(body).astype(np.uint8).tobytes(), W, H, flags, bitcount=bits,
                           **header), None

    writers = {
        "A8R8G8B8": lambda: masked(rgba, 32, argb, w.DDPF_RGB | A),
        "X8R8G8B8": lambda: masked(px, 32, argb[:3], w.DDPF_RGB),
        "R8G8B8 24-bit": lambda: masked(px, 24, argb[:3], w.DDPF_RGB),
        "R5G6B5": lambda: masked(px, 16, (0xF800, 0x7E0, 0x1F), w.DDPF_RGB),
        "L8": lambda: plain(grey, w.DDPF_LUMINANCE, 8),
        "LA16": lambda: plain(np.stack([grey, alpha], -1), w.DDPF_LUMINANCE | A, 16),
        "P8": lambda: (w.dds_bytes(palette.astype(np.uint8).tobytes() + index.astype(np.uint8).tobytes(), W, H,
                                   w.DDPF_PALETTEINDEXED8, bitcount=8), None),
        "DXT1": lambda: blocks(w.bc1_blocks, px, fourcc=b"DXT1"),
        "DXT3": lambda: blocks(w.bc2_blocks, rgba, fourcc=b"DXT3"),
        "DXT5": lambda: blocks(w.bc3_blocks, rgba, fourcc=b"DXT5"),
        "BC4": lambda: blocks(w.bc4_blocks, grey, fourcc=b"BC4U"),
        "BC5": lambda: blocks(w.bc5_blocks, px, fourcc=b"ATI2"),
        "BC5S": lambda: blocks(functools.partial(w.bc5_blocks, signed=True), px, fourcc=b"BC5S"),
        "DX10 BC1": lambda: blocks(w.bc1_blocks, px, dxgi=71),
        "BC6H UF16": lambda: blocks(w.bc6h_blocks, half, dxgi=95),
        "BC6H SF16": lambda: blocks(functools.partial(w.bc6h_blocks, signed=True), half, dxgi=96),
        "BC7": lambda: blocks(w.bc7_blocks, rgba, dxgi=98),
        "DX10 R8G8B8A8": lambda: plain(rgba, F, dxgi=28),
    }
    made = {name: write() for name, write in writers.items() if names is None or name in names}
    return made if decoded else {name: data for name, (data, _) in made.items()}


def pil_decode_ms(path, runs):
    """PIL's decode of `path` on this machine, median of `runs` (host
    clock), or why it was not measured."""
    if importlib.util.find_spec("PIL") is None:
        return "not measured"
    from PIL import Image

    times = []
    try:
        for _ in range(runs):
            t0 = time.perf_counter()
            with Image.open(path) as im:
                np.asarray(im)
            times.append((time.perf_counter() - t0) * 1e3)
    except Exception as err:  # noqa: BLE001  (an older PIL on this machine: reported, not a failure)
        return f"raised {type(err).__name__}: {err}"
    return f"{np.median(times):.2f}" + ("" if runs == 3 else f", {runs} run")


def check_dds_forms(tmp):
    """Phase 5i (a): each file of `dds_form_files` the bytes PIL read (its
    SHA-256) and, through `image_io.open_image`, PIL's mode, shape and
    pixels' SHA-256 (tests/fixtures/torch_dds/sha256.json). Returns {name:
    (the port's median ms of 5 decodes, PIL's median of 3 (of 1 for its
    Python decoder's first form) or why not)}."""
    with open(os.path.join(DDS_FIXTURES, "sha256.json")) as f:
        readings = json.load(f)["chip_smoke"]
    made = dds_form_files()
    if sorted(made) != sorted(readings):
        fail(f"DDS: this script makes {sorted(made)}, the fixture holds {sorted(readings)}")
    times = {}
    for name, data in made.items():
        want = readings[name]
        if hashlib.sha256(data).hexdigest() != want["file_sha256"]:
            fail(f"DDS: the writers made other bytes for '{name}' than the file PIL read "
                 f"(tests/fixtures/torch_dds/sha256.json)")
        path = os.path.join(tmp, "form.dds")
        with open(path, "wb") as f:
            f.write(data)
        ms = []
        for _ in range(5):
            pic, t = synced_ms(image_io.open_image, path)
            ms.append(t)
        digest = sha256_of(pic.pixels)
        if (pic.mode, list(pic.pixels.shape), digest) != (want["mode"], want["shape"], want["sha256"]):
            fail(f"DDS: {name} reads as {pic.mode} {pic.pixels.shape} with SHA-256 {digest}, not PIL's "
                 f"{want['mode']} {want['shape']} {want['sha256']}")
        if name in DDS_PIL_PYTHON:
            pil_ms = pil_decode_ms(path, 1) if name == DDS_PIL_PYTHON[0] else "not measured (PIL's Python decoder)"
        else:
            pil_ms = pil_decode_ms(path, 3)
        times[name] = (float(np.median(ms)), pil_ms)
    return times


def dds_phase(dev):
    """Phase 5i (module docstring). Returns the compositing kernels'
    launches in the train CLI run and the max abs errors of the forward,
    the backward and the routing against their plain versions at its final
    state."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dds_")
    try:
        return _dds_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _dds_phase(dev, tmp):
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # (a) One 1080p file of each form, held to PIL's committed readings.
    times = check_dds_forms(tmp)
    print(f"DDS: {len(times)} files of tests/torch_image_writers.py (1920x1080) read with PIL 12.1.0's mode, "
          f"shape and pixels (tests/fixtures/torch_dds/sha256.json); decode ms, median of 5 (host clock), beside "
          f"PIL's median of 3 on this machine ({pil_versions()}):")
    for name, (ms, pil_ms) in times.items():
        print(f"  {name}: {ms:.2f} ms (PIL {pil_ms})")

    # (b) A COLMAP dataset of trained_r5 whose views are seven of those forms.
    decoded = {}

    def write(i, cam, px, form, stem):
        body, decoded[cam.image_name] = dds_form_files(px, np.full(px.shape[:2], 255, np.uint8), [form],
                                                       decoded=True)[form]
        write_file(stem + ".dds", body)
        return os.path.basename(stem) + ".dds"

    ds = form_dataset(tmp, DDS_VIEWS, write)
    files = ds.files
    by_name = {c.image_name: c for c in ds.cameras}
    for cam, px, form in zip(ds.cams, ds.images, DDS_VIEWS):
        pic = image_io.open_image(by_name[cam.image_name].image_path)
        # the block-coded views: the pixels the writer's blocks decode to (the tests hold each writer's
        # decoding bit-equal to PIL 12.1.0's); the others: the render, alpha 255
        want = decoded[cam.image_name] if form not in DDS_LOSSLESS else opaque(px)
        if not np.array_equal(pic.pixels, want):
            fail(f"DDS: view {files[cam.image_name]} ({form}) does not read back as "
                 f"{'its render' if form in DDS_LOSSLESS else 'its blocks decode'}")
    launches, errs, (train_s, load_s, step_ms, loss0, loss1) = train_cli_on(
        "DDS", ds.data, ds.model_dir, len(DDS_VIEWS), DDS_STEPS, 59)
    print(f"  train CLI on a COLMAP dataset of {len(DDS_VIEWS)} views of trained_r5 at {W_MAIN}x{H_MAIN}, one "
          f"each {', '.join(DDS_VIEWS)} (made in {ds.build_s:.1f} s): -r 1, {DDS_STEPS} iterations in "
          f"{train_s:.2f} s (scene load {load_s:.2f} s), step median {step_ms:.3f} ms; loss "
          f"{loss0:.6f} -> {loss1:.6f}; launches {launches}")
    print(f"  phase peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
          f"wall {time.perf_counter() - t_phase:.1f} s")
    return launches, errs


# ---- phase 5j: AVIF -----------------------------------------------------------

# PIL 12.1.0's reading of each committed AVIF fixture (its mode, shape,
# pixels' SHA-256) and the file's own SHA-256, as
# tests/fixtures/torch_avif/make_fixtures.py wrote them
AVIF_FIXTURES = os.path.join(FIXTURES, "torch_avif")
AVIF_STEPS = 30
# the seven views: PIL's save options where this machine's PIL writes AVIF
# (the renders, RGBA with alpha 255), else the committed 1080p fixture.
# The card's PIL 12.2.0 (libavif 1.4.1, aom 3.13.2) turns CDEF on at its
# default speed; this phase's dataset stays as it was first made, without
# CDEF and loop restoration (AVIF_ADVANCED): phase 5k's views use both.
AVIF_VIEWS = (("4:2:0 q75", {"quality": 75}, "1080p_420_q75.avif"),
              ("4:4:4 q90", {"quality": 90, "subsampling": "4:4:4"}, "1080p_444_q90.avif"),
              ("4:0:0 q75", {"quality": 75, "subsampling": "4:0:0"}, "1080p_400_q75.avif"),
              ("RGBA q75", {"quality": 75}, "1080p_rgba_q75.avif"),
              ("limited range q75", {"quality": 75, "range": "limited"}, "1080p_limited_q75.avif"),
              ("2x2 tiles q75", {"quality": 75, "tile_rows": 1, "tile_cols": 1}, "1080p_tiles_2x2_q75.avif"),
              ("4:2:0 q50 speed 10", {"quality": 50, "speed": 10}, "1080p_420_q50_s10.avif"))
AVIF_ADVANCED = {"enable-cdef": "0", "enable-restoration": "0"}


@functools.cache
def gpu_line() -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them; fails without them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def avif_pil():
    """This machine's PIL with AVIF support (its Image module), or None."""
    if importlib.util.find_spec("PIL") is None:
        return None
    from PIL import Image, features

    return Image if features.check("avif") else None


def avif_versions() -> str:
    """PIL's version, its libavif's and its codecs', or why there are none."""
    if importlib.util.find_spec("PIL") is None:
        return "PIL: not on this machine"
    if avif_pil() is None:
        return f"PIL {importlib.metadata.version('pillow')}: no AVIF in this PIL"
    from PIL import _avif, features

    return (f"PIL {importlib.metadata.version('pillow')}, libavif {features.version('avif')}, "
            f"{_avif.codec_versions()}")


def check_avif_fixtures(names, directory=AVIF_FIXTURES):
    """Phases 5j-5m and 5q (a): each named committed AVIF fixture of
    `directory` is the file PIL read (its SHA-256) and
    `image_io.open_image` gives PIL 12.1.0's mode, shape and pixels'
    SHA-256 (its sha256.json). Returns {name: (the port's median ms of 5
    decodes, PIL's median of 3 here or why not)}, the first name and the
    split of one decode of it."""
    with open(os.path.join(directory, "sha256.json")) as f:
        readings = json.load(f)["files"]
    names = sorted(names)
    if not set(names) <= set(readings):
        fail(f"AVIF: the fixtures {sorted(set(names) - set(readings))} are not in sha256.json")
    times, split = {}, {}
    for name in names:
        want, path = readings[name], os.path.join(directory, name)
        with open(path, "rb") as f:
            data = f.read()
        if hashlib.sha256(data).hexdigest() != want["file_sha256"]:
            fail(f"AVIF: {name} is not the file PIL read ({os.path.relpath(directory, ROOT)}/sha256.json)")
        ms = []
        for _ in range(5):
            pic, t = synced_ms(image_io.open_image, path)
            ms.append(t)
        digest = sha256_of(pic.pixels)
        if (pic.mode, list(pic.pixels.shape), digest) != (want["mode"], want["shape"], want["sha256"]):
            fail(f"AVIF: {name} reads as {pic.mode} {pic.pixels.shape} with SHA-256 {digest}, not PIL's "
                 f"{want['mode']} {want['shape']} {want['sha256']}")
        times[name] = (float(np.median(ms)), pil_decode_ms(path, 3) if avif_pil() else "no AVIF in this PIL")
        if not split:
            avif.decode_avif(data, name, split=split)
    return times, names[0], split


def avif_phase(dev):
    """Phase 5j (module docstring). Returns the compositing kernels'
    launches in the train CLI run and the max abs errors of the forward,
    the backward and the routing against their plain versions at its final
    state."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_avif_")
    try:
        return _avif_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _avif_phase(dev, tmp):
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # (a) The committed 1080p files, held to PIL 12.1.0's committed readings.
    times, first, split = check_avif_fixtures([view[2] for view in AVIF_VIEWS])
    print(f"AVIF: {len(times)} committed 1080p files of tests/fixtures/torch_avif read with PIL 12.1.0's mode, "
          f"shape and pixels (sha256.json); decode ms, median of 5 (host clock), beside PIL's median of 3 on this "
          f"machine ({avif_versions()}):")
    for name, (ms, pil_ms) in times.items():
        print(f"  {name}: {ms:.2f} ms (PIL {pil_ms})")
    print(f"  one decode of {first}, host clock: " +
          ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in split.items()))

    # (b) A COLMAP dataset of trained_r5 with seven 1080p AVIF views.
    pil = avif_pil()
    with open(os.path.join(AVIF_FIXTURES, "sha256.json")) as f:
        readings = json.load(f)["files"]
    fixture_of = {}

    def write(i, cam, px, view, stem):
        label, options, fixture = view
        if pil is not None:
            rgb = np.ascontiguousarray(px[..., :3])
            pil.fromarray(opaque(rgb) if label.startswith("RGBA") else rgb).save(stem + ".avif", "AVIF", **options,
                                                                                 advanced=AVIF_ADVANCED)
        else:
            shutil.copyfile(os.path.join(AVIF_FIXTURES, fixture), stem + ".avif")
        fixture_of[cam.image_name] = fixture
        return os.path.basename(stem) + ".avif"

    ds = form_dataset(tmp, AVIF_VIEWS, write)
    files = ds.files
    for c in ds.cameras:
        pic = image_io.open_image(c.image_path)
        if pil is not None:
            with pil.open(c.image_path) as im:
                want = (im.mode, list(np.asarray(im).shape), sha256_of(np.asarray(im)))
        else:
            r = readings[fixture_of[c.image_name]]
            want = (r["mode"], r["shape"], r["sha256"])
        if (pic.mode, list(pic.pixels.shape), sha256_of(pic.pixels)) != want:
            fail(f"AVIF: view {files[c.image_name]} does not read as "
                 f"{'this machine' if pil is not None else 'PIL 12.1.0'}'s PIL reads it")
    source = (f"the renders encoded by this machine's PIL ({avif_versions()}; advanced={AVIF_ADVANCED}) and "
              "held to its decode"
              if pil is not None else "the committed 1080p fixtures (this machine's PIL has no AVIF), held to "
              "PIL 12.1.0's committed hashes")
    launches, errs, (train_s, load_s, step_ms, loss0, loss1) = train_cli_on(
        "AVIF", ds.data, ds.model_dir, len(AVIF_VIEWS), AVIF_STEPS, 61)
    print(f"  train CLI on a COLMAP dataset of {len(AVIF_VIEWS)} AVIF views of trained_r5 at {W_MAIN}x{H_MAIN} "
          f"({', '.join(v[0] for v in AVIF_VIEWS)}): {source} (made in {ds.build_s:.1f} s); -r 1, {AVIF_STEPS} "
          f"iterations in {train_s:.2f} s (scene load {load_s:.2f} s), step median {step_ms:.3f} ms; "
          f"loss {loss0:.6f} -> {loss1:.6f}; launches {launches}")
    print(f"  phase peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
          f"wall {time.perf_counter() - t_phase:.1f} s")
    return launches, errs


# ---- phase 5k: AVIF with CDEF and loop restoration ------------------------

# the committed 1080p fixtures that use CDEF and loop restoration
AVIF_FILTER_FIXTURES = ("1080p_420_q50_s2_cdef.avif", "1080p_444_q60_s4_cdef.avif", "1080p_420_q50_s0.avif")
# the seven views: PIL's save options where this machine's PIL writes AVIF
# (the renders, RGBA with alpha 255), no `advanced` option (at its default
# speed the card's PIL turns CDEF on; speeds 0-4 use loop restoration);
# else the committed fixtures in turn
AVIF_FILTER_VIEWS = (("PIL's defaults", {}), ("speed 4", {"speed": 4}), ("speed 2", {"speed": 2}),
                     ("speed 2 4:4:4", {"speed": 2, "subsampling": "4:4:4"}),
                     ("speed 2 4:0:0", {"speed": 2, "subsampling": "4:0:0"}), ("RGBA speed 4", {"speed": 4}),
                     ("2x2 tiles speed 4", {"speed": 4, "tile_rows": 1, "tile_cols": 1}))


def avif_tools(path):
    """What the decoder's hook saw the file's colour item use."""
    with open(path, "rb") as f:
        tools = {}
        avif.av1_planes(avif.parse(f.read(), path)["color"], path, tools=tools)
    return tools


def avif_tools_used(path):
    """(CDEF's 8x8 blocks, restoration units, a line saying both) of what
    the decoder's hook saw the file's colour item use."""
    tools = avif_tools(path)
    cdef = sum(sum(k.values()) for k in tools["cdef_blocks"])
    units = [sum(k.values()) for k in tools["lr_units"]]
    filtered = f"CDEF (cdef_bits {tools['cdef_bits']}, {cdef} blocks)" if cdef else "no CDEF"
    line = (f"{filtered}, restoration {'/'.join(tools['lr_types'])} ({'/'.join(map(str, units))} units)"
            f"{', 128x128 superblocks' if tools['use_128'] else ''}")
    return cdef, sum(units), line


def avif_filters_phase(dev):
    """Phase 5k (module docstring). Returns the compositing kernels'
    launches in the train CLI run and the max abs errors of the forward,
    the backward and the routing against their plain versions at its final
    state."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_avif_filters_")
    try:
        return _avif_filters_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _avif_filters_phase(dev, tmp):
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # (a) The committed 1080p files with CDEF and loop restoration.
    times, first, split = check_avif_fixtures(AVIF_FILTER_FIXTURES)
    print(f"AVIF with CDEF and loop restoration: {len(times)} committed 1080p files of tests/fixtures/torch_avif "
          f"read with PIL 12.1.0's mode, shape and pixels (sha256.json); decode ms, median of 5 (host clock), beside "
          f"PIL's median of 3 on this machine ({avif_versions()}):")
    for name, (ms, pil_ms) in times.items():
        print(f"  {name}: {ms:.2f} ms (PIL {pil_ms}); {avif_tools_used(os.path.join(AVIF_FIXTURES, name))[2]}")
    print(f"  one decode of {first}, host clock: " +
          ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in split.items()))

    # (b) A COLMAP dataset of trained_r5 with seven 1080p views that use them.
    pil = avif_pil()
    with open(os.path.join(AVIF_FIXTURES, "sha256.json")) as f:
        readings = json.load(f)["files"]
    fixture_of, labels = {}, {}

    def write(i, cam, px, view, stem):
        label, options = view
        fixture = AVIF_FILTER_FIXTURES[i % len(AVIF_FILTER_FIXTURES)]
        if pil is not None:
            rgb = np.ascontiguousarray(px[..., :3])
            pil.fromarray(opaque(rgb) if label.startswith("RGBA") else rgb).save(stem + ".avif", "AVIF", **options)
        else:
            shutil.copyfile(os.path.join(AVIF_FIXTURES, fixture), stem + ".avif")
        fixture_of[cam.image_name] = fixture
        labels[cam.image_name] = label if pil is not None else f"{label}: {fixture}"
        return os.path.basename(stem) + ".avif"

    ds = form_dataset(tmp, AVIF_FILTER_VIEWS, write)
    files, build_s = ds.files, ds.build_s
    used = []
    for c in ds.cameras:
        pic = image_io.open_image(c.image_path)
        if pil is not None:
            with pil.open(c.image_path) as im:
                want = (im.mode, list(np.asarray(im).shape), sha256_of(np.asarray(im)))
        else:
            r = readings[fixture_of[c.image_name]]
            want = (r["mode"], r["shape"], r["sha256"])
        if (pic.mode, list(pic.pixels.shape), sha256_of(pic.pixels)) != want:
            fail(f"AVIF filters: view {files[c.image_name]} does not read as "
                 f"{'this machine' if pil is not None else 'PIL 12.1.0'}'s PIL reads it")
        used.append((labels[c.image_name], *avif_tools_used(c.image_path)))
    if not any(u[1] for u in used) or not any(u[2] for u in used):
        fail(f"AVIF filters: the views do not use both CDEF and loop restoration: {used}")
    source = (f"the renders encoded by this machine's PIL ({avif_versions()}; no advanced option) and held to its "
              "decode" if pil is not None else "the committed 1080p fixtures with the filters in turn (this "
              "machine's PIL has no AVIF), held to PIL 12.1.0's committed hashes")
    print(f"  {len(used)} views, {source}, made in {build_s:.1f} s:")
    for label, _, _, line in used:
        print(f"    {label}: {line}")
    launches, errs, (train_s, load_s, step_ms, loss0, loss1) = train_cli_on(
        "AVIF filters", ds.data, ds.model_dir, len(AVIF_FILTER_VIEWS), AVIF_STEPS, 62)
    print(f"  train CLI on a COLMAP dataset of {len(AVIF_FILTER_VIEWS)} AVIF views of trained_r5 at "
          f"{W_MAIN}x{H_MAIN}: -r 1, {AVIF_STEPS} iterations in {train_s:.2f} s (scene load {load_s:.2f} s), "
          f"step median {step_ms:.3f} ms; loss {loss0:.6f} -> {loss1:.6f}; "
          f"launches {launches}; max abs errors {dict(zip(TRAIN_KERNELS, errs))}")
    print(f"  phase peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
          f"wall {time.perf_counter() - t_phase:.1f} s")
    return launches, errs


# ---- phase 5l: AVIF screen content (palette, IntraBC) ------------------------

# the committed 1080p screen-content fixtures (make_fixtures.py's
# screen_picture): palette and IntraBC together, IntraBC alone, 4:4:4
AVIF_SCREEN_FIXTURES = ("1080p_screen_420_q60.avif", "1080p_intrabc_420_q60.avif", "1080p_screen_444_q75.avif")
AVIF_SCREEN = {"tune-content": "screen"}
# the seven views: PIL's save options where this machine's PIL writes AVIF
# (the renders; "4:0:0 RGBA limited" with alpha below 255 in a band, so
# that the file has an alpha item: libyuv's I400 rows), else the fixtures
# in turn
AVIF_SCREEN_VIEWS = (("screen 4:2:0", {"quality": 60, "advanced": AVIF_SCREEN}),
                     ("screen 4:4:4", {"quality": 75, "subsampling": "4:4:4", "advanced": AVIF_SCREEN}),
                     ("IntraBC alone", {"quality": 60, "advanced": {**AVIF_SCREEN, "enable-palette": "0"}}),
                     ("4:0:0 RGBA limited", {"quality": 60, "subsampling": "4:0:0", "range": "limited",
                                             "advanced": AVIF_SCREEN}),
                     ("screen 4:2:2 limited", {"quality": 50, "subsampling": "4:2:2", "range": "limited",
                                               "advanced": AVIF_SCREEN}),
                     ("2x2 tiles", {"quality": 60, "tile_rows": 1, "tile_cols": 1, "advanced": AVIF_SCREEN}),
                     ("PIL's defaults", {}))


def avif_screen_tools(path):
    """(Y palette blocks, UV palette blocks, IntraBC blocks, a line) of what
    the decoder's hook saw the file's colour item use."""
    tools = avif_tools(path)
    y, uv, ibc = (sum(tools[k].values()) for k in ("palette_y", "palette_uv", "intrabc"))
    line = (f"palette Y {y} / UV {uv} blocks, IntraBC {ibc} ({tools['intrabc']['default']} by the default DV), "
            f"var-tx depths {tools['vartx_depths']}, inter tx sets {tools['inter_tx_sets']}")
    return y, uv, ibc, line


def screen_panel(seed):
    """make_fixtures.py's seeded desktop-like screen_picture, a third of
    the view each way (640x360): the panel 5l pastes into its views where
    the renders alone do not reach palette and IntraBC."""
    spec = importlib.util.spec_from_file_location("avif_make_fixtures",
                                                  os.path.join(AVIF_FIXTURES, "make_fixtures.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.screen_picture(H_MAIN // 3, W_MAIN // 3, seed)


def avif_screen_phase(dev):
    """Phase 5l (module docstring). Returns the compositing kernels'
    launches in the train CLI run and the max abs errors of the forward,
    the backward and the routing against their plain versions at its final
    state."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_avif_screen_")
    try:
        return _avif_screen_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _avif_screen_phase(dev, tmp):
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # (a) The committed 1080p screen-content files.
    times, first, split = check_avif_fixtures(AVIF_SCREEN_FIXTURES)
    print(f"AVIF screen content (palette, IntraBC): {len(times)} committed 1080p files of tests/fixtures/torch_avif "
          f"read with PIL 12.1.0's mode, shape and pixels (sha256.json); decode ms, median of 5 (host clock), beside "
          f"PIL's median of 3 on this machine ({avif_versions()}):")
    for name, (ms, pil_ms) in times.items():
        print(f"  {name}: {ms:.2f} ms (PIL {pil_ms}); {avif_screen_tools(os.path.join(AVIF_FIXTURES, name))[3]}")
    print(f"  one decode of {first}, host clock: " +
          ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in split.items()))

    # (b) A COLMAP dataset of trained_r5 with seven 1080p screen-content views.
    pil = avif_pil()
    with open(os.path.join(AVIF_FIXTURES, "sha256.json")) as f:
        readings = json.load(f)["files"]
    alpha = np.full((H_MAIN, W_MAIN), 255, np.uint8)
    alpha[H_MAIN // 3:H_MAIN // 3 + 96] = 160
    fixture_of, labels, used = {}, {}, [None] * len(AVIF_SCREEN_VIEWS)
    panel = None

    def write(i, cam, px, view, stem):
        """The view's file (the render, with `panel` at a corner where
        given); `used[i]`: what it used."""
        label, options = view
        fixture = AVIF_SCREEN_FIXTURES[i % len(AVIF_SCREEN_FIXTURES)]
        if pil is not None:
            rgb = np.array(px[..., :3])
            if panel is not None:
                y0, x0 = (i % 2) * (H_MAIN - panel.shape[0]), ((i // 2) % 2) * (W_MAIN - panel.shape[1])
                rgb[y0:y0 + panel.shape[0], x0:x0 + panel.shape[1]] = panel
            pic = np.concatenate([rgb, alpha[..., None]], -1) if "RGBA" in label else rgb
            pil.fromarray(pic).save(stem + ".avif", "AVIF", **options)
        else:
            shutil.copyfile(os.path.join(AVIF_FIXTURES, fixture), stem + ".avif")
        fixture_of[cam.image_name] = fixture
        labels[cam.image_name] = label if pil is not None else f"{label}: {fixture}"
        used[i] = avif_screen_tools(stem + ".avif")
        return os.path.basename(stem) + ".avif"

    ds = form_dataset(tmp, AVIF_SCREEN_VIEWS, write)
    files, cams, build_s = ds.files, ds.cams, ds.build_s
    panel_needed = pil is not None and not all(any(u[k] for u in used) for k in range(3))
    if panel_needed:  # the same files again, each render with a panel
        t0 = time.perf_counter()
        panel = screen_panel(23)
        for i, (cam, px, view) in enumerate(zip(cams, ds.images, AVIF_SCREEN_VIEWS)):
            write(i, cam, px, view, os.path.join(ds.data, "images", cam.image_name))
        build_s += time.perf_counter() - t0
    if not all(any(u[k] for u in used) for k in range(3)):
        fail(f"AVIF screen: the views do not use Y palette, UV palette and IntraBC: {[u[3] for u in used]}")
    for c in ds.cameras:
        pic = image_io.open_image(c.image_path)
        if pil is not None:
            with pil.open(c.image_path) as im:
                want = (im.mode, list(np.asarray(im).shape), sha256_of(np.asarray(im)))
        else:
            r = readings[fixture_of[c.image_name]]
            want = (r["mode"], r["shape"], r["sha256"])
        if (pic.mode, list(pic.pixels.shape), sha256_of(pic.pixels)) != want:
            fail(f"AVIF screen: view {files[c.image_name]} ({labels[c.image_name]}) does not read as "
                 f"{'this machine' if pil is not None else 'PIL 12.1.0'}'s PIL reads it")
    if pil is not None:
        source = (f"the renders encoded by this machine's PIL ({avif_versions()}), "
                  + ("each with a seeded 640x360 screen panel pasted at a corner (the renders alone did not use "
                     "Y palette, UV palette and IntraBC)" if panel_needed else "the renders alone")
                  + ", held to its decode")
    else:
        source = ("the committed 1080p screen-content fixtures in turn (this machine's PIL has no AVIF), held to "
                  "PIL 12.1.0's committed hashes")
    print(f"  {len(used)} views, {source}, made in {build_s:.1f} s:")
    for cam, u in zip(cams, used):
        print(f"    {labels[cam.image_name]}: {u[3]}")
    launches, errs, (train_s, load_s, step_ms, loss0, loss1) = train_cli_on(
        "AVIF screen", ds.data, ds.model_dir, len(AVIF_SCREEN_VIEWS), AVIF_STEPS, 63)
    print(f"  train CLI on a COLMAP dataset of {len(AVIF_SCREEN_VIEWS)} AVIF views of trained_r5 at "
          f"{W_MAIN}x{H_MAIN}: -r 1, {AVIF_STEPS} iterations in {train_s:.2f} s (scene load {load_s:.2f} s), "
          f"step median {step_ms:.3f} ms; loss {loss0:.6f} -> {loss1:.6f}; "
          f"launches {launches}; max abs errors {dict(zip(TRAIN_KERNELS, errs))}")
    print(f"  phase peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
          f"wall {time.perf_counter() - t_phase:.1f} s")
    return launches, errs


# ---- phase 5m: AVIF film grain and image sequences -------------------------

# the committed 1080p fixtures with film grain: aom's test vector 10 at
# 4:2:0, grain estimated from a textured picture at 4:4:4, an RGBA 3-frame
# `avis` sequence with grain on colour and alpha
AVIF_GRAIN_FIXTURES = ("1080p_grain_420_test10.avif", "1080p_denoise_444.avif", "1080p_grain_rgba_avis.avif")
AVIF_GRAIN_SHIFT = 8  # pixels each later frame of a sequence view is moved right
# the seven views: PIL's save options where this machine's PIL writes AVIF
# (the renders, grain from aom's test vectors; the "RGBA" views with alpha
# 160 in a band, so that the file has an alpha item; the "avis" views as
# sequences of the render and two shifted renders), else the fixtures in turn
AVIF_GRAIN_VIEWS = (("test vector 1, 4:2:0", {"quality": 60, "advanced": {"film-grain-test": "1"}}),
                    ("test vector 10, 4:2:0", {"quality": 60, "advanced": {"film-grain-test": "10"}}),
                    ("test vector 6, 4:2:2 limited", {"quality": 55, "subsampling": "4:2:2", "range": "limited",
                                                      "advanced": {"film-grain-test": "6"}}),
                    ("test vector 12, 4:4:4", {"quality": 75, "subsampling": "4:4:4",
                                               "advanced": {"film-grain-test": "12"}}),
                    ("test vector 3, 4:0:0 RGBA", {"quality": 60, "subsampling": "4:0:0",
                                                   "advanced": {"film-grain-test": "3"}}),
                    ("avis, test vector 4", {"quality": 60, "advanced": {"film-grain-test": "4"}}),
                    ("avis RGBA premultiplied, test vector 2", {"quality": 60, "alpha_premultiplied": True,
                                                               "advanced": {"film-grain-test": "2"}}))


def avif_grain_tools(path):
    """(the colour item's film grain parameters, the source libavif reads
    (tracks or item), a line) of what the decoder's hook saw the file use."""
    with open(path, "rb") as f:
        info = avif.parse(f.read(), path)
    grains = []
    for item in ("color", "alpha"):
        if info[item] is not None:
            tools = {}
            avif.av1_planes(info[item], path, tools=tools)
            grains.append(tools["film_grain"])
    g = grains[0]
    line = (f"{info['source']}; grain " + (f"lag {g['ar_coeff_lag']}, points Y {g['num_y_points']} / Cb "
                                           f"{g['num_cb_points']} / Cr {g['num_cr_points']}, overlap "
                                           f"{g['overlap_flag']}, clip {g['clip_to_restricted_range']}"
                                           if g["apply_grain"] else "none")
            + ("" if len(grains) < 2 else f"; alpha grain {'on' if grains[1]['apply_grain'] else 'off'}"))
    return g, info["source"], line


def avif_grain_phase(dev):
    """Phase 5m (module docstring). Returns the compositing kernels'
    launches in the train CLI run and the max abs errors of the forward,
    the backward and the routing against their plain versions at its final
    state."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_avif_grain_")
    try:
        return _avif_grain_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _avif_grain_phase(dev, tmp):
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # (a) The committed 1080p files with film grain, one of them a sequence.
    times, first, split = check_avif_fixtures(AVIF_GRAIN_FIXTURES)
    print(f"AVIF film grain and sequences: {len(times)} committed 1080p files of tests/fixtures/torch_avif read "
          f"with PIL 12.1.0's mode, shape and pixels (sha256.json); decode ms, median of 5 (host clock), beside "
          f"PIL's median of 3 on this machine ({avif_versions()}) [{gpu_line()}]:")
    for name, (ms, pil_ms) in times.items():
        print(f"  {name}: {ms:.2f} ms (PIL {pil_ms}); {avif_grain_tools(os.path.join(AVIF_FIXTURES, name))[2]}")
    total = sum(split.values())
    print(f"  one decode of {first}, host clock: " + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in split.items())
          + f"; film grain {100 * split['av1_film_grain'] / total:.1f}% of {total * 1e3:.2f} ms")

    # (b) A COLMAP dataset of trained_r5 with seven 1080p views with grain.
    pil = avif_pil()
    with open(os.path.join(AVIF_FIXTURES, "sha256.json")) as f:
        readings = json.load(f)["files"]
    alpha = np.full((H_MAIN, W_MAIN, 1), 255, np.uint8)
    alpha[H_MAIN // 3:H_MAIN // 3 + 96] = 160
    fixture_of, labels, used = {}, {}, []

    def write(i, cam, px, view, stem):
        label, options = view
        path = stem + ".avif"
        fixture = AVIF_GRAIN_FIXTURES[i % len(AVIF_GRAIN_FIXTURES)]
        if pil is not None:
            rgb = np.ascontiguousarray(px[..., :3])
            pic = np.concatenate([rgb, alpha], -1) if "RGBA" in label else rgb
            if label.startswith("avis"):
                frames = [np.ascontiguousarray(np.roll(pic, AVIF_GRAIN_SHIFT * k, axis=1)) for k in range(3)]
                pil.fromarray(frames[0]).save(path, "AVIF", save_all=True,
                                              append_images=[pil.fromarray(p) for p in frames[1:]], **options)
            else:
                pil.fromarray(pic).save(path, "AVIF", **options)
        else:
            shutil.copyfile(os.path.join(AVIF_FIXTURES, fixture), path)
        fixture_of[cam.image_name] = fixture
        labels[cam.image_name] = label if pil is not None else f"{label}: {fixture}"
        used.append(avif_grain_tools(path))
        return os.path.basename(path)

    ds = form_dataset(tmp, AVIF_GRAIN_VIEWS, write)
    files, cams, build_s = ds.files, ds.cams, ds.build_s
    if not (any(g["apply_grain"] and g["num_y_points"] for g, _, _ in used)
            and any(g["apply_grain"] and (g["num_cb_points"] or g["chroma_scaling_from_luma"]) for g, _, _ in used)
            and any(g["apply_grain"] and g["overlap_flag"] for g, _, _ in used)
            and any(source == "tracks" for _, source, _ in used)):
        fail(f"AVIF grain: the views do not use luma and chroma grain, overlap_flag and an avis track: "
             f"{[u[2] for u in used]}")
    for c in ds.cameras:
        pic = image_io.open_image(c.image_path)
        if pil is not None:
            with pil.open(c.image_path) as im:
                want = (im.mode, list(np.asarray(im).shape), sha256_of(np.asarray(im)))
        else:
            r = readings[fixture_of[c.image_name]]
            want = (r["mode"], r["shape"], r["sha256"])
        if (pic.mode, list(pic.pixels.shape), sha256_of(pic.pixels)) != want:
            fail(f"AVIF grain: view {files[c.image_name]} ({labels[c.image_name]}) does not read as "
                 f"{'this machine' if pil is not None else 'PIL 12.1.0'}'s PIL reads it")
    source = (f"the renders encoded by this machine's PIL ({avif_versions()}) with grain (aom's test vectors; "
              f"the avis views as sequences of the render and two renders shifted {AVIF_GRAIN_SHIFT} and "
              f"{2 * AVIF_GRAIN_SHIFT} px), held to its decode" if pil is not None else
              "the committed 1080p grain fixtures in turn (this machine's PIL has no AVIF), held to PIL 12.1.0's "
              "committed hashes")
    print(f"  {len(used)} views, {source}, made in {build_s:.1f} s:")
    for cam, u in zip(cams, used):
        print(f"    {labels[cam.image_name]}: {u[2]}")
    launches, errs, (train_s, load_s, step_ms, loss0, loss1) = train_cli_on(
        "AVIF grain", ds.data, ds.model_dir, len(AVIF_GRAIN_VIEWS), AVIF_STEPS, 64)
    print(f"  train CLI on a COLMAP dataset of {len(AVIF_GRAIN_VIEWS)} AVIF views of trained_r5 at "
          f"{W_MAIN}x{H_MAIN}: -r 1, {AVIF_STEPS} iterations in {train_s:.2f} s (scene load {load_s:.2f} s), "
          f"step median {step_ms:.3f} ms; loss {loss0:.6f} -> {loss1:.6f}; "
          f"launches {launches}; max abs errors {dict(zip(TRAIN_KERNELS, errs))}")
    print(f"  phase peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
          f"wall {time.perf_counter() - t_phase:.1f} s")
    return launches, errs


# ---- phase 5n: arithmetic-coded and lossless JPEG ---------------------------

# PIL 12.1.0's reading of each committed arithmetic-coded 1080p file (its
# mode, shape, pixels' SHA-256, or "raises") and the file's own SHA-256, as
# tests/fixtures/torch_jpeg_arith/make_fixtures.py wrote them
JPEG_ARITH_FIXTURES = os.path.join(FIXTURES, "torch_jpeg_arith")
JPEG_ARITH_STEPS = 30
# the seven views: the three committed arithmetic-coded files (PIL's JPEGs
# of this orbit's views 0-2 from an earlier run, transcoded; at 1080p PIL
# reads an arithmetic file only at a quality whose scans fit the 65536-byte
# blocks PIL has read when libjpeg decodes them), then views 3-6 coded
# lossless here by tests/torch_image_writers.py's lossless_jpeg (libjpeg-
# turbo converts no colours in lossless mode, so PIL reads RGB and grey
# ones, not YCbCr)
JPEG_ARITH_VIEWS = (
    ("arithmetic sequential 4:2:0 q60, a restart every 4 MCU rows", "1080p_seq_420_q60_rows4.jpg", None),
    ("arithmetic progressive 4:2:0 q55", "1080p_prog_420_q55.jpg", None),
    ("arithmetic sequential 4:4:4 q40, DAC L 1, U 3, Kx 10", "1080p_seq_444_q40_dac.jpg", None),
    ("lossless RGB, predictor 1", None, {"psv": 1}),
    ("lossless RGB, predictor 7, Pt 1", None, {"psv": 7, "pt": 1}),
    ("lossless RGB sampled 2x2, 1x1, 1x1, predictor 4, a restart every 8 MCU rows, no marker", None,
     {"sampling": [(2, 2), (1, 1), (1, 1)], "psv": 4, "restart_rows": 8, "marker": None}),
    ("lossless grey, predictor 6, a restart every 16 rows", None, {"psv": 6, "restart_rows": 16, "grey": True}))


def jpeg_versions() -> str:
    """PIL's version and its libjpeg-turbo's on this machine (the rules the
    port follows were found against PIL 12.1.0 with libjpeg-turbo 3.1.3)."""
    if importlib.util.find_spec("PIL") is None:
        return "PIL: not on this machine"
    from PIL import features

    return f"PIL {importlib.metadata.version('pillow')}, libjpeg-turbo {features.version('libjpeg_turbo')}"


def pil_reading(path):
    """(mode, shape, pixels' SHA-256) of this machine's PIL's reading of
    `path`, "raises", or None where there is no PIL."""
    if importlib.util.find_spec("PIL") is None:
        return None
    from PIL import Image

    try:
        with Image.open(path) as im:
            im.load()  # an icns image packs its pixels otherwise before it loads (PIL's tobytes)
            a = np.asarray(im)
            return im.mode, list(a.shape), sha256_of(a)
    except Exception:  # noqa: BLE001  (PIL raises OSError, SyntaxError, ...: a refusal to hold the port to)
        return "raises"


def jpeg_arith_phase(dev):
    """Phase 5n (module docstring). Returns the compositing kernels'
    launches in the train CLI run and the max abs errors of the forward,
    the backward and the routing against their plain versions at its final
    state."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_jpeg_arith_")
    try:
        return _jpeg_arith_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _jpeg_arith_phase(dev, tmp):
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # (a) The committed 1080p arithmetic-coded files, one of them refused.
    with open(os.path.join(JPEG_ARITH_FIXTURES, "sha256.json")) as f:
        readings = json.load(f)["files"]
    print(f"JPEG arithmetic coding and lossless: {len(readings)} committed 1080p files of "
          f"tests/fixtures/torch_jpeg_arith held to PIL 12.1.0's reading (sha256.json) and to this machine's "
          f"({jpeg_versions()}); decode ms, median of 5 (host clock), beside that PIL's [{gpu_line()}]:")
    for name in sorted(readings):
        want, path = readings[name], os.path.join(JPEG_ARITH_FIXTURES, name)
        with open(path, "rb") as f:
            if hashlib.sha256(f.read()).hexdigest() != want["file_sha256"]:
                fail(f"JPEG arith: {name} is not the file PIL read (sha256.json)")
        here = pil_reading(path)
        if want.get("pil") == "raises":
            try:
                image_io.open_image(path)
                fail(f"JPEG arith: the port reads {name}, which PIL refuses")
            except ValueError as err:
                if "past the bytes PIL has read" not in str(err):
                    fail(f"JPEG arith: {name} refused for another reason: {err}")
            if here not in (None, "raises"):
                fail(f"JPEG arith: this machine's PIL reads {name}, which PIL 12.1.0 refuses")
            print(f"  {name}: refused by the port (its scan runs past PIL's first 65536 bytes) and by PIL 12.1.0 "
                  f"and this machine's PIL ({'raises' if here else 'not run'})")
            continue
        ms = []
        for _ in range(5):
            pic, t = synced_ms(image_io.open_image, path)
            ms.append(t)
        got = (pic.mode, list(pic.pixels.shape), sha256_of(pic.pixels))
        if got != (want["mode"], want["shape"], want["sha256"]) or here not in (None, got):
            fail(f"JPEG arith: {name} reads as {got}, not as PIL 12.1.0 ({want}) or this machine's PIL ({here})")
        print(f"  {name}: {float(np.median(ms)):.2f} ms (PIL {pil_decode_ms(path, 5)})")

    # (b) A COLMAP dataset of trained_r5 with seven 1080p arithmetic-coded
    # and lossless views.
    writers = image_writers()
    labels, coded = {}, {}  # coded: the samples a full-size lossless view holds

    def write(i, cam, px, view, stem):
        label, fixture, options = view
        labels[cam.image_name], path = label, stem + ".jpg"
        if fixture is not None:
            shutil.copyfile(os.path.join(JPEG_ARITH_FIXTURES, fixture), path)
            return os.path.basename(path)
        options = dict(options)
        rgb = np.ascontiguousarray(px[..., :3])
        pic = np.round(rgb @ np.array([0.299, 0.587, 0.114])).astype(np.uint8) if options.pop("grey", False) else rgb
        write_file(path, writers.lossless_jpeg(pic, **options))
        if "sampling" not in options:
            pt = options.get("pt", 0)
            coded[cam.image_name] = ("L" if pic.ndim == 2 else "RGB", list(pic.shape), sha256_of((pic >> pt) << pt))
        return os.path.basename(path)

    ds = form_dataset(tmp, JPEG_ARITH_VIEWS, write)
    files = ds.files
    print(f"  {len(JPEG_ARITH_VIEWS)} views of trained_r5 at {W_MAIN}x{H_MAIN}, made in {ds.build_s:.1f} s; decode "
          f"ms, median of 5 (host clock), beside this machine's PIL's:")
    for c in ds.cameras:
        ms = []
        for _ in range(5):
            pic, t = synced_ms(image_io.open_image, c.image_path)
            ms.append(t)
        px = pic.pixels[..., 0] if pic.pixels.shape[2] == 1 else pic.pixels  # np.asarray's shape of an "L" image
        got = (pic.mode, list(px.shape), sha256_of(px))
        here = pil_reading(c.image_path)
        if here is None:  # no PIL: the committed files to PIL 12.1.0's hashes, the lossless ones to their samples
            fixture = next(fx for lb, fx, _ in JPEG_ARITH_VIEWS if lb == labels[c.image_name])
            here = (readings[fixture]["mode"], readings[fixture]["shape"], readings[fixture]["sha256"]) \
                if fixture else coded.get(c.image_name, got)
        if got != here:
            fail(f"JPEG arith: view {files[c.image_name]} ({labels[c.image_name]}) reads as {got}, "
                 f"not as this machine's PIL reads it ({here})")
        with open(c.image_path, "rb") as f:
            size = len(f.read())
        print(f"    {labels[c.image_name]}: {size} bytes, {pic.mode}, {float(np.median(ms)):.2f} ms "
              f"(PIL {pil_decode_ms(c.image_path, 5)})")
    launches, errs, (train_s, load_s, step_ms, loss0, loss1) = train_cli_on(
        "JPEG arith", ds.data, ds.model_dir, len(JPEG_ARITH_VIEWS), JPEG_ARITH_STEPS, 65)
    print(f"  train CLI on a COLMAP dataset of {len(JPEG_ARITH_VIEWS)} arithmetic-coded and lossless JPEG views "
          f"of trained_r5 at {W_MAIN}x{H_MAIN}: -r 1, {JPEG_ARITH_STEPS} iterations in {train_s:.2f} s (scene load "
          f"{load_s:.2f} s), step median {step_ms:.3f} ms; loss {loss0:.6f} -> {loss1:.6f}; "
          f"launches {launches}; max abs errors {dict(zip(TRAIN_KERNELS, errs))}")
    print(f"  phase peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
          f"wall {time.perf_counter() - t_phase:.1f} s")
    return launches, errs


# ---- phase 5o: BLP, FTEX, GBR, FITS, FLI, ICNS, EPS and the stubs ----------

# PIL's reading of each 1080p file of `rare_form_files` and of the committed
# icns files (its mode, shape, pixels' SHA-256) and each file's own SHA-256,
# as tests/fixtures/torch_rare_forms/make_fixtures.py wrote them with PIL 12.1.0
RARE_FIXTURES = os.path.join(FIXTURES, "torch_rare_forms")
RARE_STEPS = 30
RARE_VIEWS = ("BLP1 JPEG", "BLP2 DXT1", "BLP2 DXT5", "BLP2 palette", "FTEX DXT1", "GBR v2 RGBA", "FITS 8-bit")
RARE_EXT = {"BLP1": ".blp", "BLP2": ".blp", "FTEX": ".ftc", "GBR": ".gbr", "FITS": ".fits", "FLC": ".flc",
            "ICNS": ".icns"}
# forms PIL decodes in Python (its BLP palette lookup and DXT decoders,
# FitsGzipDecoder): 0.7-3 s a 1080p file, so 5o times PIL on them once
RARE_PIL_PYTHON = ("BLP1 palette", "BLP2 palette", "BLP2 DXT1", "BLP2 DXT3", "BLP2 DXT5", "FITS gzip")
RARE_STUBS = {"BUFR": b"BUFR" + bytes(60), "GRIB": b"GRIB\0\0\0\1" + bytes(60),
              "HDF5": b"\x89HDF\r\n\x1a\n" + bytes(60)}


def cube_palette(px):
    """(indices (H, W) uint8, palette (256, 4) BGRA uint8): each pixel's
    cell of a 6 x 7 x 6 colour cube, integers only."""
    r, g, b = (px[..., 0].astype(np.int64) * 6 >> 8, px[..., 1].astype(np.int64) * 7 >> 8,
               px[..., 2].astype(np.int64) * 6 >> 8)
    idx = (r * 42 + g * 6 + b).astype(np.uint8)
    cells = np.arange(252)
    palette = np.zeros((256, 4), np.uint8)
    palette[:252] = np.stack([(cells % 6) * 255 // 5, (cells // 6 % 7) * 255 // 6, (cells // 42) * 255 // 5,
                              np.full(252, 255)], -1)
    return idx, palette


def pil_timed_reading(path, runs):
    """This machine's PIL's reading of `path` ((mode, shape, pixels'
    SHA-256) of the loaded image, or "raises") and its decode time, median
    of `runs` (host clock); (None, "not measured") without a PIL."""
    if importlib.util.find_spec("PIL") is None:
        return None, "not measured"
    from PIL import Image

    times = []
    try:
        for _ in range(runs):
            t0 = time.perf_counter()
            with Image.open(path) as im:
                im.load()  # an icns image packs its pixels otherwise before it loads (PIL's tobytes)
                a = np.asarray(im)
            times.append((time.perf_counter() - t0) * 1e3)
    except Exception as err:  # noqa: BLE001  (PIL refuses the file: a reading to hold the port to)
        return "raises", f"raised {type(err).__name__}"
    return (im.mode, list(a.shape), sha256_of(a)), f"{np.median(times):.2f}" + ("" if runs == 3 else f", {runs} run")


def rare_form_files(px=None, alpha=None, names=None):
    """The files of phase 5o in the forms of BLP, FTEX, GBR, FITS, FLI and
    ICNS, written by tests/torch_image_writers.py from `px` (default: the
    form picture at 1920x1080) and `alpha` (default a ramp of 128..255):
    {name: bytes}, of every form or of `names`. The BLP1's JPEG is
    lossless (integers only, so the same bytes on every machine); the icon
    is 128x128 (it32 and t8mk)."""
    w = image_writers()
    px = form_picture() if px is None else px
    H, W = px.shape[:2]
    if alpha is None:
        yy, xx = np.mgrid[0:H, 0:W]
        alpha = (128 + (3 * xx + 5 * yy) % 128).astype(np.uint8)
    rgba = np.concatenate([px, alpha[..., None]], -1)
    grey = ((px.astype(np.int64) @ np.array([299, 587, 114])) // 1000).astype(np.uint8)
    idx, palette = cube_palette(px)
    flc_palette = palette[:, [2, 1, 0]]

    def fits16():
        return w.fits_bytes(grey.astype(np.int64) * 257 - 32768, 16)

    writers = {
        "BLP1 JPEG": lambda: w.blp1_bytes(W, H, 0, jpeg=w.lossless_jpeg(px)),
        "BLP1 palette": lambda: w.blp1_bytes(W, H, 1, palette=palette, indices=idx.tobytes()),
        "BLP2 palette": lambda: w.blp2_bytes(W, H, idx.tobytes(), alpha_depth=8, palette=palette),
        "BLP2 DXT1": lambda: w.blp2_bytes(W, H, w.bc1_blocks(px).tobytes(), encoding=2),
        "BLP2 DXT3": lambda: w.blp2_bytes(W, H, w.bc2_blocks(rgba).tobytes(), encoding=2, alpha_depth=8,
                                          alpha_encoding=1),
        "BLP2 DXT5": lambda: w.blp2_bytes(W, H, w.bc3_blocks(rgba).tobytes(), encoding=2, alpha_depth=8,
                                          alpha_encoding=7),
        "FTEX DXT1": lambda: w.ftex_bytes(W, H, w.bc1_blocks(px).tobytes(), fmt=0),
        "FTEX raw": lambda: w.ftex_bytes(W, H, np.ascontiguousarray(px).tobytes()),
        "GBR v1 L": lambda: w.gbr_bytes(grey[..., None], version=1),
        "GBR v2 RGBA": lambda: w.gbr_bytes(rgba),
        "FITS 8-bit": lambda: w.fits_bytes(grey, 8),
        "FITS 16-bit": fits16,
        "FITS gzip": lambda: w.fits_gzip_bytes(grey, 8),
        "FLC BRUN": lambda: w.fli_bytes(W, H, [w.fli_frame([w.fli_palette(flc_palette), w.fli_brun(idx)])]),
        "ICNS 128 it32 + t8mk": lambda: w.icns_bytes([(b"it32", w.icns_rgb(px[:128, :128], it32=True)),
                                                      (b"t8mk", alpha[:128, :128].tobytes())]),
    }
    return {name: write() for name, write in writers.items() if names is None or name in names}


def check_rare_forms(tmp):
    """Phase 5o (a): each file of `rare_form_files` and each committed icns
    file the bytes PIL read (its SHA-256) and, through
    `image_io.open_image`, PIL 12.1.0's mode, shape and pixels' SHA-256
    (tests/fixtures/torch_rare_forms/sha256.json), and this machine's PIL's
    reading where it has one. Returns {name: (the port's median ms of 5
    decodes, PIL's median of 3 (of 1 for PIL's Python decoders) or why
    not)}."""
    with open(os.path.join(RARE_FIXTURES, "sha256.json")) as f:
        fixture = json.load(f)
    readings, committed = fixture["chip_smoke"], fixture["files"]
    made = rare_form_files()
    if sorted(made) != sorted(readings):
        fail(f"rare forms: this script makes {sorted(made)}, the fixture holds {sorted(readings)}")
    paths = {}
    for name, data in made.items():
        if hashlib.sha256(data).hexdigest() != readings[name]["file_sha256"]:
            fail(f"rare forms: the writers made other bytes for '{name}' than the file PIL read "
                 f"(tests/fixtures/torch_rare_forms/sha256.json)")
        paths[name] = os.path.join(tmp, f"form_{len(paths)}" + RARE_EXT[name.split()[0]])
        with open(paths[name], "wb") as f:
            f.write(data)
    for name in sorted(committed):
        if name.startswith("icns_1024"):
            paths[name] = os.path.join(RARE_FIXTURES, name)
            readings[name] = committed[name]
            with open(paths[name], "rb") as f:
                if hashlib.sha256(f.read()).hexdigest() != committed[name]["file_sha256"]:
                    fail(f"rare forms: {name} is not the file PIL read (sha256.json)")
    times = {}
    for name, path in paths.items():
        want = readings[name]
        ms = []
        for _ in range(5):
            pic, t = synced_ms(image_io.open_image, path)
            ms.append(t)
        got = (pic.mode, list(pic.pixels.shape), sha256_of(pic.pixels))
        if got != (want["mode"], want["shape"], want["sha256"]):
            fail(f"rare forms: {name} reads as {got}, not as PIL 12.1.0 ({want})")
        here, pil_ms = pil_timed_reading(path, 1 if name in RARE_PIL_PYTHON else 3)
        if here not in (None, (got[0], got[1] if got[1][2] > 1 else got[1][:2], got[2])):
            fail(f"rare forms: {name} reads as {got}, not as this machine's PIL ({here})")
        times[name] = (float(np.median(ms)), pil_ms)
    if len(times) != len(made) + 2:
        fail(f"rare forms: {len(times)} files read, not the {len(made)} written and the 2 committed icns files")
    return times


def check_rare_refusals(tmp):
    """Phase 5o (a): BUFR, GRIB and HDF5 raise, naming the format, in the
    port and in this machine's PIL; EPS: where this machine has `gs`, the
    port's pixels are its PIL's, else both raise naming Ghostscript.
    Returns what it found of Ghostscript."""
    from gaussian_splatting_torch.utils import eps

    w = image_writers()
    for fmt, data in RARE_STUBS.items():
        path = os.path.join(tmp, "stub." + fmt.lower())
        with open(path, "wb") as f:
            f.write(data)
        try:
            image_io.open_image(path)
            fail(f"rare forms: the port reads a {fmt} stub file")
        except ValueError as err:
            if f"a {fmt} file" not in str(err):
                fail(f"rare forms: the {fmt} stub refused for another reason: {err}")
        if pil_reading(path) not in (None, "raises"):
            fail(f"rare forms: this machine's PIL reads the {fmt} stub file")
    path = os.path.join(tmp, "view.eps")
    with open(path, "wb") as f:
        f.write(w.eps_bytes(bbox=(0, 0, 640, 360), body=b"0.2 setgray 0 0 640 360 rectfill\n1 0 0 setrgbcolor "
                                                          b"100 100 200 120 rectfill\nshowpage\n"))
    gs = eps.has_ghostscript()
    here = pil_reading(path)
    try:
        pic = image_io.open_image(path)
        got = (pic.mode, list(pic.pixels.shape) if pic.pixels.shape[2] > 1 else list(pic.pixels.shape[:2]),
               sha256_of(pic.pixels))
    except ValueError as err:
        if gs or "Ghostscript" not in str(err):
            fail(f"rare forms: the port refuses the EPS file ({err}) with gs {gs}")
        got = "raises"
    if here is not None and here != got:
        fail(f"rare forms: the EPS file reads as {got} in the port and {here} in this machine's PIL")
    return f"gs {'on PATH' if gs else 'not on this machine'}: EPS {got if got == 'raises' else got[:2]}"


def rare_plain_reading(form, px):
    """(mode, pixels as np.asarray gives them) of the 5o view `form` made
    from the opaque render `px`, by PIL's rules from the writers' own
    values, for a machine without PIL: BLP1's lossless JPEG set as raw
    BGR, BLP2's DXT blocks through PIL's Python decoders' rules
    (`blp.blp_dxt_decode`'s plain version, held to PIL by
    tests/test_torch_rare_forms.py), the palette looked up, FTEX's DXT1
    as the writer decodes its blocks, GBR and FITS raw."""
    from gaussian_splatting_torch.utils import blp

    w = image_writers()
    H, W = px.shape[:2]
    rgba = np.concatenate([px, np.full((H, W, 1), 255, np.uint8)], -1)
    if form == "BLP1 JPEG":
        return "RGB", px[..., ::-1]
    if form in ("BLP2 DXT1", "BLP2 DXT5"):
        kind, c = (1, 3) if form == "BLP2 DXT1" else (5, 4)
        blocks = (w.bc1_blocks(px) if kind == 1 else w.bc3_blocks(rgba)).tobytes()
        stream = blp.blp_dxt_decode(blocks, kind, kind == 5, W, H, form, plain=True)
        return ("RGB" if c == 3 else "RGBA"), stream[:H * W * c].reshape(H, W, c)
    if form == "BLP2 palette":
        idx, palette = cube_palette(px)
        return "RGBA", palette[:, [2, 1, 0, 3]][idx]
    if form == "FTEX DXT1":
        return "RGBA", w.bc1_blocks(px, decoded=True)[1]
    if form == "GBR v2 RGBA":
        return "RGBA", rgba
    return "L", ((px.astype(np.int64) @ np.array([299, 587, 114])) // 1000).astype(np.uint8)


def rare_forms_phase(dev):
    """Phase 5o (module docstring). Returns the compositing kernels'
    launches in the train CLI run and the max abs errors of the forward,
    the backward and the routing against their plain versions at its final
    state."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rare_")
    try:
        return _rare_forms_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rare_forms_phase(dev, tmp):
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # (a) The 1080p files and the icons, held to PIL's committed readings;
    # the stubs and EPS refused or drawn as this machine's PIL does.
    times = check_rare_forms(tmp)
    print(f"rare forms: {len(times)} files (tests/torch_image_writers.py's at 1920x1080, an it32 icon at "
          f"128x128, the committed 1024x1024 icns files) read with PIL 12.1.0's mode, shape and pixels "
          f"(tests/fixtures/torch_rare_forms/sha256.json); decode ms, median of 5 (host clock), beside this "
          f"machine's PIL ({jpeg_versions()}; median of 3, of 1 for PIL's Python decoders) [{gpu_line()}]:")
    for name, (ms, pil_ms) in times.items():
        print(f"  {name}: {ms:.2f} ms (PIL {pil_ms})")
    print(f"  BUFR, GRIB and HDF5 refused by the port and this machine's PIL; {check_rare_refusals(tmp)}")

    # (b) A COLMAP dataset of trained_r5 whose views are seven of those forms.
    labels, plain = {}, {}

    def write(i, cam, px, form, stem):
        px = np.ascontiguousarray(px[..., :3])
        write_file(stem + RARE_EXT[form.split()[0]],
                   rare_form_files(px, np.full(px.shape[:2], 255, np.uint8), [form])[form])
        labels[cam.image_name], plain[cam.image_name] = form, px
        return os.path.basename(stem) + RARE_EXT[form.split()[0]]

    ds = form_dataset(tmp, RARE_VIEWS, write)
    files = ds.files
    print(f"  {len(RARE_VIEWS)} views of trained_r5 at {W_MAIN}x{H_MAIN}, made in {ds.build_s:.1f} s; decode ms, "
          f"median of 5 (host clock), beside this machine's PIL's:")
    for c in ds.cameras:
        ms = []
        for _ in range(5):
            pic, t = synced_ms(image_io.open_image, c.image_path)
            ms.append(t)
        px = pic.pixels[..., 0] if pic.pixels.shape[2] == 1 else pic.pixels  # np.asarray's shape of an "L" image
        got = (pic.mode, list(px.shape), sha256_of(px))
        form = labels[c.image_name]
        here, pil_ms = pil_timed_reading(c.image_path, 1 if form in RARE_PIL_PYTHON else 3)
        if here is None:
            mode, want = rare_plain_reading(form, plain[c.image_name])
            here = (mode, list(want.shape), sha256_of(want))
        if got != here:
            fail(f"rare forms: view {files[c.image_name]} ({labels[c.image_name]}) reads as {got}, not as PIL's "
                 f"rules give it ({here})")
        print(f"    {form}: {pic.mode}, {float(np.median(ms)):.2f} ms (PIL {pil_ms})")
    launches, errs, (train_s, load_s, step_ms, loss0, loss1) = train_cli_on(
        "rare forms", ds.data, ds.model_dir, len(RARE_VIEWS), RARE_STEPS, 67)
    print(f"  train CLI on a COLMAP dataset of {len(RARE_VIEWS)} views of trained_r5 at {W_MAIN}x{H_MAIN}, one "
          f"each {', '.join(RARE_VIEWS)}: -r 1, {RARE_STEPS} iterations in {train_s:.2f} s (scene load "
          f"{load_s:.2f} s), step median {step_ms:.3f} ms; loss {loss0:.6f} -> {loss1:.6f}; launches {launches}; "
          f"max abs errors {dict(zip(TRAIN_KERNELS, errs))}")
    print(f"  phase peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
          f"wall {time.perf_counter() - t_phase:.1f} s")
    return launches, errs


# ---- phase 5p: IM, IMT, IPTC, McIDAS, MSP, PCD, PIXAR, SPIDER, SUN, XBM, XPM, XV -----

# PIL's reading of each file of `pil_rest_files` (its mode, shape, pixels'
# SHA-256) and each file's own SHA-256, as
# tests/fixtures/torch_pil_rest/make_fixtures.py wrote them with PIL 12.1.0
PIL_REST_FIXTURES = os.path.join(FIXTURES, "torch_pil_rest")
PIL_REST_STEPS = 30
PIL_REST_VIEWS = ("IM RGB", "SUN raw BGR", "SUN RLE BGR", "PIXAR", "IMT", "McIDAS 8-bit", "IPTC raw L")
PIL_REST_EXT = {"IM": ".im", "IMT": ".imt", "McIDAS": ".area", "PIXAR": ".pxr", "SPIDER": ".spi", "SUN": ".ras",
                "MSP": ".msp", "XBM": ".xbm", "XPM": ".xpm", "XV": ".xv", "PCD": ".pcd", "IPTC": ".iim"}
# forms PIL decodes in Python (its MspDecoder and XpmDecoder): 5p times PIL on them once
PIL_REST_PIL_PYTHON = ("MSP v2", "XPM")


def pil_rest_refused():
    """MPEG, a placeable WMF and an EMF: {format: bytes}."""
    w = image_writers()
    return {"MPEG": w.mpeg_bytes(1920, 1080), "WMF": w.wmf_bytes(), "EMF": w.emf_bytes()}


def pil_rest_files(px=None, names=None):
    """The files of phase 5p in the forms of IM, IMT, McIDAS, PIXAR,
    SPIDER, SUN, MSP, XBM, XPM, XV thumbnails, PhotoCD and IPTC, written by
    tests/torch_image_writers.py from `px` (default: the form picture at
    1920x1080; the PhotoCD files from its 768x512 corner): {name: bytes},
    of every form or of `names`. Integers only: the same bytes on every
    machine."""
    w = image_writers()
    px = form_picture() if px is None else px
    H, W = px.shape[:2]
    p = px.astype(np.int64)
    grey = ((p @ np.array([299, 587, 114])) // 1000).astype(np.uint8)
    ycc = np.stack([(p @ np.array([299, 587, 114])) // 1000,
                    np.clip(128 + (p @ np.array([-169, -331, 500])) // 1000, 0, 255),
                    np.clip(128 + (p @ np.array([500, -419, -81])) // 1000, 0, 255)], -1).astype(np.uint8)
    idx, palette = cube_palette(px)
    xv = ((p[..., 0] >> 5) << 5 | (p[..., 1] >> 5) << 2 | p[..., 2] >> 6).astype(np.uint8)
    bits = grey > 128

    def im(image_type, body, **kw):
        return lambda: w.im_bytes(image_type, W, H, body(), **kw)

    def pcd(orientation):
        return lambda: w.pcd_bytes(*w.pcd_ycc(px[:512, :768]), orientation=orientation)

    writers = {
        "IM RGB": im("RGB image", lambda: w.pack_raw(px, "RGB;L", True)),
        "IM YCbCr": im("YCC image", lambda: w.pack_raw(ycc, "YCbCr;L", True)),
        "IM P": im("Greyscale image", lambda: w.pack_raw(idx, "L", True), lut=palette[:, [2, 1, 0]]),
        "IMT": lambda: w.imt_bytes(grey),
        "McIDAS 8-bit": lambda: w.mcidas_bytes(grey, 1),
        "McIDAS 16-bit": lambda: w.mcidas_bytes(grey.astype(np.int64) * 257, 2),
        "PIXAR": lambda: w.pixar_bytes(px),
        "SPIDER": lambda: w.spider_bytes(grey.astype(np.float32) / 4),
        "SUN raw BGR": lambda: w.sun_bytes(W, H, 24, w.pack_raw(px, "BGR"), 1),
        "SUN RLE BGR": lambda: w.sun_bytes(W, H, 24, w.pack_raw(px, "BGR"), 2),
        "MSP v2": lambda: w.msp_bytes(bits),
        "XBM": lambda: w.xbm_bytes(bits),
        "XPM": lambda: w.xpm_bytes(idx, palette[:252, [2, 1, 0]]),
        "XV": lambda: w.xv_bytes(xv),
        "PCD": pcd(0),
        "PCD rotated": pcd(1),
        "IPTC raw L": lambda: w.iptc_bytes(W, H, grey.tobytes()),
    }
    return {name: write() for name, write in writers.items() if names is None or name in names}


def check_pil_rest_forms(tmp):
    """Phase 5p (a): each file of `pil_rest_files` the bytes PIL read (its
    SHA-256) and, through `image_io.open_image`, PIL 12.1.0's mode, shape
    and pixels' SHA-256 (tests/fixtures/torch_pil_rest/sha256.json), and
    this machine's PIL's reading where it has one. Returns {name: (the
    port's median ms of 5 decodes, PIL's median of 3 (of 1 for PIL's
    Python decoders) or why not)}."""
    with open(os.path.join(PIL_REST_FIXTURES, "sha256.json")) as f:
        readings = json.load(f)["chip_smoke"]
    made = pil_rest_files()
    if sorted(made) != sorted(readings):
        fail(f"PIL's other forms: this script makes {sorted(made)}, the fixture holds {sorted(readings)}")
    times = {}
    for name, data in made.items():
        want = readings[name]
        if hashlib.sha256(data).hexdigest() != want["file_sha256"]:
            fail(f"PIL's other forms: the writers made other bytes for '{name}' than the file PIL read "
                 f"(tests/fixtures/torch_pil_rest/sha256.json)")
        path = os.path.join(tmp, f"form_{len(times)}" + PIL_REST_EXT[name.split()[0]])
        with open(path, "wb") as f:
            f.write(data)
        ms = []
        for _ in range(5):
            pic, t = synced_ms(image_io.open_image, path)
            ms.append(t)
        got = (pic.mode, list(pic.pixels.shape), sha256_of(pic.pixels))
        if got != (want["mode"], want["shape"], want["sha256"]):
            fail(f"PIL's other forms: {name} reads as {got}, not as PIL 12.1.0 ({want})")
        here, pil_ms = pil_timed_reading(path, 1 if name in PIL_REST_PIL_PYTHON else 3)
        if here not in (None, (got[0], got[1] if got[1][2] > 1 else got[1][:2], got[2])):
            fail(f"PIL's other forms: {name} reads as {got}, not as this machine's PIL ({here})")
        times[name] = (float(np.median(ms)), pil_ms, got[0], got[1])
        os.remove(path)
    return times


def check_pil_rest_refusals(tmp):
    """Phase 5p (a): MPEG, a placeable WMF and an EMF raise, naming the
    format, in the port and in this machine's PIL."""
    for fmt, data in pil_rest_refused().items():
        path = os.path.join(tmp, "refused." + fmt.lower())
        with open(path, "wb") as f:
            f.write(data)
        try:
            image_io.open_image(path)
            fail(f"PIL's other forms: the port reads the {fmt} file")
        except ValueError as err:
            if f"{fmt} file" not in str(err):
                fail(f"PIL's other forms: the {fmt} file refused for another reason: {err}")
        if pil_reading(path) not in (None, "raises"):
            fail(f"PIL's other forms: this machine's PIL reads the {fmt} file")


def pil_rest_plain_reading(form, px):
    """(mode, pixels as np.asarray gives them) of the 5p view `form` made
    from the opaque render `px`, by the writers' own values, for a machine
    without PIL: the RGB forms the render, the grey ones its grey."""
    if form in ("IM RGB", "SUN raw BGR", "SUN RLE BGR", "PIXAR"):
        return "RGB", px
    return "L", ((px.astype(np.int64) @ np.array([299, 587, 114])) // 1000).astype(np.uint8)


def pil_rest_phase(dev):
    """Phase 5p (module docstring). Returns the compositing kernels'
    launches in the train CLI run and the max abs errors of the forward,
    the backward and the routing against their plain versions at its final
    state."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pil_rest_")
    try:
        return _pil_rest_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _pil_rest_phase(dev, tmp):
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # (a) The files, held to PIL's committed readings; MPEG and WMF / EMF
    # refused as this machine's PIL refuses them.
    times = check_pil_rest_forms(tmp)
    print(f"PIL's other forms: {len(times)} files (tests/torch_image_writers.py's at {W_MAIN}x{H_MAIN}, PhotoCD at "
          f"768x512) read with PIL 12.1.0's mode, shape and pixels (tests/fixtures/torch_pil_rest/sha256.json); "
          f"decode ms, median of 5 (host clock), beside this machine's PIL ({jpeg_versions()}; median of 3, of 1 "
          f"for PIL's Python decoders) [{gpu_line()}]:")
    for name, (ms, pil_ms, mode, shape) in times.items():
        print(f"  {name}: {mode} {shape}, {ms:.2f} ms (PIL {pil_ms})")
    check_pil_rest_refusals(tmp)
    print("  MPEG, a placeable WMF and an EMF refused by the port and this machine's PIL")

    # (b) A COLMAP dataset of trained_r5 whose views are seven of those forms.
    labels, plain = {}, {}

    def write(i, cam, px, form, stem):
        px = np.ascontiguousarray(px[..., :3])
        write_file(stem + PIL_REST_EXT[form.split()[0]], pil_rest_files(px, [form])[form])
        labels[cam.image_name], plain[cam.image_name] = form, px
        return os.path.basename(stem) + PIL_REST_EXT[form.split()[0]]

    ds = form_dataset(tmp, PIL_REST_VIEWS, write)
    files = ds.files
    print(f"  {len(PIL_REST_VIEWS)} views of trained_r5 at {W_MAIN}x{H_MAIN}, made in {ds.build_s:.1f} s; decode "
          f"ms, median of 5 (host clock), beside this machine's PIL's:")
    for c in ds.cameras:
        ms = []
        for _ in range(5):
            pic, t = synced_ms(image_io.open_image, c.image_path)
            ms.append(t)
        px = pic.pixels[..., 0] if pic.pixels.shape[2] == 1 else pic.pixels  # np.asarray's shape of an "L" image
        got = (pic.mode, list(px.shape), sha256_of(px))
        form = labels[c.image_name]
        here, pil_ms = pil_timed_reading(c.image_path, 3)
        if here is None:
            mode, want = pil_rest_plain_reading(form, plain[c.image_name])
            here = (mode, list(want.shape), sha256_of(want))
        if got != here:
            fail(f"PIL's other forms: view {files[c.image_name]} ({form}) reads as {got}, not as PIL's rules give "
                 f"it ({here})")
        print(f"    {form}: {pic.mode}, {float(np.median(ms)):.2f} ms (PIL {pil_ms})")
    launches, errs, (train_s, load_s, step_ms, loss0, loss1) = train_cli_on(
        "PIL's other forms", ds.data, ds.model_dir, len(PIL_REST_VIEWS), PIL_REST_STEPS, 71)
    print(f"  train CLI on a COLMAP dataset of {len(PIL_REST_VIEWS)} views of trained_r5 at {W_MAIN}x{H_MAIN}, one "
          f"each {', '.join(PIL_REST_VIEWS)}: -r 1, {PIL_REST_STEPS} iterations in {train_s:.2f} s (scene load "
          f"{load_s:.2f} s), step median {step_ms:.3f} ms; loss {loss0:.6f} -> {loss1:.6f}; launches {launches}; "
          f"max abs errors {dict(zip(TRAIN_KERNELS, errs))}")
    print(f"  phase peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
          f"wall {time.perf_counter() - t_phase:.1f} s")
    return launches, errs


# ---- phase 5q: AVIF grid images ------------------------------------------------

# PIL 12.1.0's reading of each committed grid fixture (its mode, shape,
# pixels' SHA-256) and the file's own SHA-256, as
# tests/fixtures/torch_avif_grid/make_fixtures.py wrote them
AVIF_GRID_FIXTURES = os.path.join(FIXTURES, "torch_avif_grid")
AVIF_GRID_STEPS = 30
# one grid past AV1's baseline cap of 8192x4352 a frame: 2x2 cells of 4096x2304
AVIF_GRID_BIG = (8192, 4608, (4096, 2304))
# the seven views, written by this machine's PIL's libavif: (label, cell
# width and height, subsampling, full range, an alpha grid). libavif writes
# no alpha for an opaque picture, so the RGBA view has alpha 160 in a band
# (as 5m's)
AVIF_GRID_VIEWS = (("2x2 of 960x540, 4:2:0", (960, 540), "4:2:0", True, False),
                   ("2x1 of 1024x1080, the right column cropped to 896", (1024, 1080), "4:2:0", True, False),
                   ("3x2 of 640x540, 4:4:4", (640, 540), "4:4:4", True, False),
                   ("2x2 of 960x540, 4:0:0", (960, 540), "4:0:0", True, False),
                   ("2x2 of 960x540, RGBA with an alpha grid", (960, 540), "4:2:0", True, True),
                   ("2x2 of 960x540, limited range", (960, 540), "4:2:0", False, False),
                   ("1x2 of 1920x540", (1920, 540), "4:2:0", True, False))


def avif_grid_file(w, px, cell, subsampling="4:2:0", full_range=True, alpha=False):
    """The bytes of an RGB picture as a grid of `cell`s written by this
    machine's PIL's libavif (tests/torch_image_writers.py's
    avif_grid_bytes, quality 60, speed 8, every core), with `alpha` an
    alpha grid of 255 but 160 in a band; None without that libavif."""
    if alpha:
        alpha = np.full(px.shape[:2], 255, np.uint8)
        alpha[H_MAIN // 3:H_MAIN // 3 + 96] = 160
    else:
        alpha = None
    return w.avif_grid_bytes(w.yuv_planes(px[..., :3], subsampling, full_range), cell, subsampling, full_range,
                             alpha=alpha, quality=60, speed=8, threads=os.cpu_count() or 1)


def avif_grid_phase(dev):
    """Phase 5q (module docstring). Returns the compositing kernels'
    launches in the train CLI run and the max abs errors of the forward,
    the backward and the routing against their plain versions at its final
    state."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_avif_grid_")
    try:
        return _avif_grid_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _avif_grid_phase(dev, tmp):
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    w = image_writers()
    writes = w.avif_library() is not None and avif_pil() is not None

    # (a) The committed grids, held to PIL 12.1.0's committed readings, and
    # one grid past the baseline cap, written and read here.
    with open(os.path.join(AVIF_GRID_FIXTURES, "sha256.json")) as f:
        readings = json.load(f)["files"]
    times, first, split = check_avif_fixtures(list(readings), AVIF_GRID_FIXTURES)
    print(f"AVIF grids: {len(times)} committed files of tests/fixtures/torch_avif_grid read with PIL 12.1.0's "
          f"mode, shape and pixels (sha256.json); decode ms, median of 5 (host clock), beside PIL's median of 3 on "
          f"this machine ({avif_versions()}) [{gpu_line()}]:")
    for name, (ms, pil_ms) in times.items():
        print(f"  {name}: {ms:.2f} ms (PIL {pil_ms})")
    total = sum(split.values())
    print(f"  one decode of {first}, host clock: " + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in split.items())
          + f"; the cells' copies {100 * split[avif.GRID_KEY] / total:.2f}% of {total * 1e3:.2f} ms")
    W, H, cell = AVIF_GRID_BIG
    if writes:
        big = np.ascontiguousarray(np.tile(form_picture(), (-(-H // H_MAIN), -(-W // W_MAIN), 1))[:H, :W])
        t0 = time.perf_counter()
        data = avif_grid_file(w, big, cell)
        encode_s = time.perf_counter() - t0
        path = os.path.join(tmp, "big_grid.avif")
        write_file(path, data)
        big_split = {}
        pic, ms = synced_ms(lambda: avif.decode_avif(data, path, split=big_split))
        got = (pic.mode, list(pic.pixels.shape), sha256_of(pic.pixels))
        here, pil_ms = pil_timed_reading(path, 1)
        if got != here:
            fail(f"AVIF grid: the {W}x{H} grid reads as {got}, not as this machine's PIL reads it ({here})")
        print(f"  a {W}x{H} grid of 2x2 cells of {cell[0]}x{cell[1]} at 4:2:0 ({len(data)} bytes, written by this "
              f"machine's libavif in {encode_s:.1f} s): {ms:.2f} ms, once (PIL {pil_ms}); "
              + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in big_split.items()))
    else:
        print(f"  the {W}x{H} grid: not written (no libavif in this machine's PIL)")

    # (b) A COLMAP dataset of trained_r5 with seven 1080p grid views.
    fixture = "1080p_grid_420_2x2.avif"

    def write(i, cam, px, view, stem):
        label, cell_, subsampling, full_range, alpha = view
        if writes:
            write_file(stem + ".avif", avif_grid_file(w, px, cell_, subsampling, full_range, alpha))
        else:
            shutil.copyfile(os.path.join(AVIF_GRID_FIXTURES, fixture), stem + ".avif")
        return os.path.basename(stem) + ".avif"

    ds = form_dataset(tmp, AVIF_GRID_VIEWS, write)
    source = (f"the renders written as grids by this machine's libavif ({avif_versions()}) and held to its PIL's "
              "reading" if writes else f"the committed {fixture} for each (this machine's PIL ships no libavif), "
              "held to PIL 12.1.0's committed hash")
    print(f"  {len(AVIF_GRID_VIEWS)} views of trained_r5 at {W_MAIN}x{H_MAIN}, {source}, made in {ds.build_s:.1f} s; "
          f"decode ms, median of 5 (host clock), beside this machine's PIL's:")
    labels = {cam.image_name: view[0] for cam, view in zip(ds.cams, AVIF_GRID_VIEWS)}
    for c in ds.cameras:
        ms = []
        for _ in range(5):
            pic, t = synced_ms(image_io.open_image, c.image_path)
            ms.append(t)
        got = (pic.mode, list(pic.pixels.shape), sha256_of(pic.pixels))
        here, pil_ms = pil_timed_reading(c.image_path, 3)
        if not writes:
            here = tuple(readings[fixture][k] for k in ("mode", "shape", "sha256"))
        g = avif.parse(open(c.image_path, "rb").read(), c.image_path)["color"]
        if got != here or not isinstance(g, avif._Grid):
            fail(f"AVIF grid: view {ds.files[c.image_name]} ({labels[c.image_name]}) reads as {got}, not as PIL "
                 f"reads it ({here}), or is no grid")
        print(f"    {labels[c.image_name]}: {g.cols}x{g.rows} cells of {g.sizes[0][0]}x{g.sizes[0][1]}, {pic.mode}, "
              f"{float(np.median(ms)):.2f} ms (PIL {pil_ms})")
    launches, errs, (train_s, load_s, step_ms, loss0, loss1) = train_cli_on(
        "AVIF grid", ds.data, ds.model_dir, len(AVIF_GRID_VIEWS), AVIF_GRID_STEPS, 73)
    print(f"  train CLI on a COLMAP dataset of {len(AVIF_GRID_VIEWS)} AVIF grid views of trained_r5 at "
          f"{W_MAIN}x{H_MAIN}: -r 1, {AVIF_GRID_STEPS} iterations in {train_s:.2f} s (scene load {load_s:.2f} s), "
          f"step median {step_ms:.3f} ms; loss {loss0:.6f} -> {loss1:.6f}; launches {launches}; "
          f"max abs errors {dict(zip(TRAIN_KERNELS, errs))}")
    print(f"  phase peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
          f"wall {time.perf_counter() - t_phase:.1f} s")
    return launches, errs


# ---- phase 5r: AVIF at 10 and 12 bits ------------------------------------------

# PIL 12.1.0's reading of each committed high-depth file and of the
# relabelled 8-bit fixtures ("<name>@<depth>"), as
# tests/fixtures/torch_avif_hbd/make_fixtures.py wrote them
AVIF_HBD_FIXTURES = os.path.join(FIXTURES, "torch_avif_hbd")
AVIF_HBD_STEPS = 30
# the 1080p fixtures of tests/fixtures/torch_avif relabelled in (a); the
# first one's decode is split
AVIF_HBD_RELABELLED = ("1080p_420_q50_s2_cdef.avif@10", "1080p_444_q60_s4_cdef.avif@12",
                       "1080p_grain_420_test10.avif@10", "1080p_intrabc_420_q60.avif@12")
# the seven views: (label, PIL's save options, depth, the nclx matrix
# written over PIL's or None, the relabelled fixture read where this
# machine's PIL writes no AVIF). The RGBA view has alpha 160 in a band.
AVIF_HBD_VIEWS = (("10-bit 4:2:0", {"quality": 75}, 10, None, "1080p_420_q75.avif@10"),
                  ("10-bit 4:4:4 (profile 1)", {"quality": 75, "subsampling": "4:4:4"}, 10, None,
                   "1080p_444_q90.avif@10"),
                  ("10-bit 4:2:2 (profile 2)", {"quality": 75, "subsampling": "4:2:2"}, 10, None,
                   "1080p_420_q50_s10.avif@10"),
                  ("12-bit 4:2:0 (profile 2)", {"quality": 75}, 12, None, "1080p_420_q75.avif@12"),
                  ("10-bit 4:0:0", {"quality": 75, "subsampling": "4:0:0"}, 10, None, "1080p_400_q75.avif@10"),
                  ("10-bit RGBA", {"quality": 75}, 10, None, "1080p_rgba_q75.avif@10"),
                  ("10-bit limited range, BT.709", {"quality": 75, "range": "limited"}, 10, 1,
                   "1080p_limited_q75.avif@10"))


def avif_hbd_file(w, key):
    """A committed 8-bit fixture relabelled: key "<name>@<depth>"."""
    name, depth = key.split("@")
    with open(os.path.join(AVIF_FIXTURES, name), "rb") as f:
        return w.avif_high_depth(f.read(), int(depth))


def with_nclx_matrix(data: bytes, mc: int) -> bytes:
    """PIL's file with its `colr` nclx box's matrix_coefficients set."""
    at = data.index(b"colrnclx") + 8  # primaries, transfer, matrix (16 bits each), full range
    return data[:at + 4] + mc.to_bytes(2, "big") + data[at + 6:]


def colour_av1(info) -> bytes:
    """The AV1 data of a parsed file's colour item (a grid's first cell)."""
    return info["color"].cells[0] if isinstance(info["color"], avif._Grid) else info["color"]


def avif_hbd_phase(dev):
    """Phase 5r (module docstring). Returns the compositing kernels'
    launches in the train CLI run and the max abs errors of the forward,
    the backward and the routing against their plain versions at its final
    state."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_avif_hbd_")
    try:
        return _avif_hbd_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _avif_hbd_phase(dev, tmp):
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    w = image_writers()
    pil = avif_pil()

    # (a) The committed high-depth files and four relabelled 1080p fixtures,
    # held to PIL 12.1.0's committed readings.
    with open(os.path.join(AVIF_HBD_FIXTURES, "sha256.json")) as f:
        readings = json.load(f)
    files = [(name, readings["files"][name], os.path.join(AVIF_HBD_FIXTURES, name), None)
             for name in sorted(readings["files"])]
    for key in AVIF_HBD_RELABELLED:
        path = os.path.join(tmp, key.replace("@", "_") + ".avif")
        write_file(path, avif_hbd_file(w, key))
        files.append((key, readings["relabelled"][key], path, key))
    print(f"AVIF at 10 and 12 bits: {len(files)} files (tests/fixtures/torch_avif_hbd, and 1080p fixtures of "
          f"tests/fixtures/torch_avif relabelled) read with PIL 12.1.0's mode, shape and pixels (sha256.json); "
          f"decode ms, median of 5 (host clock), beside PIL's median of 3 on this machine ({avif_versions()}) "
          f"[{gpu_line()}]:")
    split = {}
    for name, want, path, key in files:
        with open(path, "rb") as f:
            data = f.read()
        if hashlib.sha256(data).hexdigest() != want["file_sha256"]:
            fail(f"AVIF at high depth: {name} is not the file PIL 12.1.0 read (tests/fixtures/torch_avif_hbd/"
                 "sha256.json)")
        ms = []
        for _ in range(5):
            pic, t = synced_ms(image_io.open_image, path)
            ms.append(t)
        got = (pic.mode, list(pic.pixels.shape), sha256_of(pic.pixels))
        committed = (want["mode"], want["shape"], want["sha256"])
        if got != committed:
            fail(f"AVIF at high depth: {name} reads as {got}, not as PIL 12.1.0 reads it {committed}")
        here, pil_ms = pil_timed_reading(path, 3) if pil is not None else (None, "no AVIF in this PIL")
        depth = w.av1_color_config(w.av1_sequence_header(colour_av1(avif.parse(data, name))))["depth"]
        differs = "" if here in (None, committed) else f"; this machine's PIL reads {here}, not the committed " \
                                                       f"{committed}"
        print(f"  {name} ({depth}-bit {pic.mode} {pic.pixels.shape[1]}x{pic.pixels.shape[0]}): "
              f"{float(np.median(ms)):.2f} ms (PIL {pil_ms}){differs}")
        if key == AVIF_HBD_RELABELLED[0]:
            avif.decode_avif(data, name, split=split)
    print(f"  one decode of {AVIF_HBD_RELABELLED[0]}, host clock: " +
          ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in split.items()))

    # (b) A COLMAP dataset of trained_r5 with seven 1080p views at 10 and 12 bits.
    alpha = np.full((H_MAIN, W_MAIN, 1), 255, np.uint8)
    alpha[H_MAIN // 3:H_MAIN // 3 + 96] = 160

    def write(i, cam, px, view, stem):
        label, options, depth, mc, fixture = view
        if pil is not None:
            rgb = np.ascontiguousarray(px[..., :3])
            buf = io.BytesIO()
            pil.fromarray(np.concatenate([rgb, alpha], -1) if label.endswith("RGBA") else rgb).save(
                buf, "AVIF", **options)
            data = w.avif_high_depth(buf.getvalue(), depth)
            write_file(stem + ".avif", data if mc is None else with_nclx_matrix(data, mc))
        else:
            write_file(stem + ".avif", avif_hbd_file(w, fixture))
        return os.path.basename(stem) + ".avif"

    ds = form_dataset(tmp, AVIF_HBD_VIEWS, write)
    source = (f"the renders encoded by this machine's PIL ({avif_versions()}), relabelled, and held to its "
              "decode" if pil is not None else "the committed 1080p fixtures relabelled (this machine's PIL has "
              "no AVIF), held to PIL 12.1.0's committed hashes")
    print(f"  {len(AVIF_HBD_VIEWS)} views of trained_r5 at {W_MAIN}x{H_MAIN}, {source}, made in {ds.build_s:.1f} s; "
          f"decode ms, median of 5 (host clock), beside this machine's PIL's:")
    views = {cam.image_name: view for cam, view in zip(ds.cams, AVIF_HBD_VIEWS)}
    for c in ds.cameras:
        label, _, depth, _, fixture = views[c.image_name]
        ms = []
        for _ in range(5):
            pic, t = synced_ms(image_io.open_image, c.image_path)
            ms.append(t)
        got = (pic.mode, list(pic.pixels.shape), sha256_of(pic.pixels))
        here, pil_ms = pil_timed_reading(c.image_path, 3)
        if pil is None:
            here = tuple(readings["relabelled"][fixture][k] for k in ("mode", "shape", "sha256"))
        with open(c.image_path, "rb") as f:
            said = w.av1_color_config(w.av1_sequence_header(colour_av1(avif.parse(f.read(), c.image_path))))
        if got != here or said["depth"] != depth:
            fail(f"AVIF at high depth: view {ds.files[c.image_name]} ({label}) reads as {got}, not as PIL reads it "
                 f"({here}), or is not of {depth} bits ({said['depth']})")
        print(f"    {label}: profile {said['profile']}, {pic.mode}, {float(np.median(ms)):.2f} ms (PIL {pil_ms})")
    launches, errs, (train_s, load_s, step_ms, loss0, loss1) = train_cli_on(
        "AVIF at high depth", ds.data, ds.model_dir, len(AVIF_HBD_VIEWS), AVIF_HBD_STEPS, 79)
    print(f"  train CLI on a COLMAP dataset of {len(AVIF_HBD_VIEWS)} 10- and 12-bit AVIF views of trained_r5 at "
          f"{W_MAIN}x{H_MAIN}: -r 1, {AVIF_HBD_STEPS} iterations in {train_s:.2f} s (scene load {load_s:.2f} s), "
          f"step median {step_ms:.3f} ms; loss {loss0:.6f} -> {loss1:.6f}; launches {launches}; "
          f"max abs errors {dict(zip(TRAIN_KERNELS, errs))}")
    print(f"  phase peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
          f"wall {time.perf_counter() - t_phase:.1f} s")
    return launches, errs


# ---- phase 5d: the sharded path -------------------------------------------

SHARD_STRIPS = (2, 4)  # strips of the in-process kernel check at an origin
RANKS = 2  # ranks of the gloo run, both on the one card
RANK_TIMEOUT = 600  # seconds for the two ranks' processes together
SHARDED_TRAINER_STEPS = 60
# A random subset of trained_r5's centres that leaves 64 free rows of its
# 65,536: the first densify that adds more takes the host path and doubles
# the rows; the rest run on the device. The reset at 40.
SHARDED_TRAINER_POINTS = 65_472
SHARDED_TRAINER_OPT = OptimizationConfig(densify_from_iter=5, densification_interval=5,
                                         densify_until_iter=SHARDED_TRAINER_STEPS,
                                         opacity_reset_interval=40)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def strip_inputs(prep, n, r, W, H, tile):
    """Rank r's strip of n: the forward kernel's scene arguments on the
    strip's clipped tile lists, the lists, the entry count, its height and
    its row origin."""
    geo = sharding.StripGeometry.of(W, H, *tile, n)
    lo = r * geo.rows_per
    rmin, rmax, tiles = sharding.strip_rects(prep.rect_min, prep.rect_max, prep.visible, lo,
                                             geo.rows_per)
    capacity = RasterizerConfig(capacity_exact=max(int(tiles.sum()), 1)).capacity(tiles.shape[0])
    lists = binning.build_tile_lists(rmin, rmax, prep.depths, tiles, geo.grid_x, geo.rows_per,
                                     capacity)
    args = (lists.gauss_id, lists.tile_start, lists.tile_stop, prep.means2d, prep.conic,
            prep.rgb, prep.opacity)
    return args, lists, int(lists.total), geo.strip_h, lo * tile[1]


def check_strips(acts, cam, bg, full):
    """The compositing kernels on trained_r5's strips at their row origins
    (SHARD_STRIPS strips of 32x32 tile rows at 1920x1080), by phase 3's
    rules against their plain versions at the same origin, the cull
    included; the stitched image and final T bit-equal to the full frame's
    kernel output `full`. Returns the max abs errors of the forward, the
    backward and the routing."""
    err = [0.0, 0.0, 0.0]
    with torch.no_grad():
        prep = preprocess(*acts, 3, cam, W_MAIN, H_MAIN, 32, 32)
    for n in SHARD_STRIPS:
        images, final_ts = [], []
        for r in range(n):
            args, lists, total, Hs, oy = strip_inputs(prep, n, r, W_MAIN, H_MAIN, (32, 32))
            name = f"strip {r} of {n} (origin_y {oy}, K={total})"
            with torch.no_grad():
                out = composite_fwd_cuda(*args, bg, W_MAIN, Hs, 32, 32, origin_y=oy)
                ref = composite_fwd_torch(*args, bg, W_MAIN, Hs, 32, 32, origin_y=oy)
            torch.cuda.synchronize()
            err[0] = max(err[0], compare(name, out, ref, 1e-5))
            check_cull(name, out, args, bg, W_MAIN, Hs, (32, 32), origin_y=oy)
            e_rows, e_route = check_backward(name, args, lists, bg, W_MAIN, Hs, (32, 32),
                                             seed=50 + r, origin_y=oy)
            err[1], err[2] = max(err[1], e_rows), max(err[2], e_route)
            images.append(out.image)
            final_ts.append(out.final_t)
        for field, got, want in (("image", torch.cat(images)[:H_MAIN], full.image),
                                 ("final_t", torch.cat(final_ts)[:H_MAIN], full.final_t)):
            if not torch.equal(got, want):
                fail(f"{n} strips: the stitched {field} differs from the full frame's at "
                     f"{int((got != want).sum())} elements")
        print(f"  {n} strips stitched: image and final_t bit-equal to the full frame's kernel")
    return err


def sharded_steps(mesh, gt, cam, capacity):
    """STEPS sharded train steps of trained_r5 from its PLY, as phase 5's
    single-device steps (same camera, target, capacity, optimizer). Returns
    this rank's metrics per step, its rows after step 1 and its statistics
    after the last, its host-clock step times, launches and peak memory."""
    model = load_gaussians_ply(TRAINED_PLY)
    n = len(model["xyz"])  # padded with dead rows to a multiple of every rank count
    padded, alive = repad(model, np.ones(n, bool), -(-n // 4) * 4)
    state = sharding.shard_train_state(init_train_state(params_from_numpy(padded, alive)), mesh)
    rows = state.params.num_points
    step = sharding.make_sharded_train_step(mesh, 3, W_MAIN, H_MAIN,
                                            RasterizerConfig(capacity_exact=capacity),
                                            OptimizationConfig(), 1.0)
    bg0 = torch.zeros(3, device=gt.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = {k: [] for k in ("loss", "num_visible", "num_entries", "max_strip_entries", "ms")}
    for it in range(1, STEPS + 1):
        t0 = time.perf_counter()
        m = step(state, cam, gt, bg0, it)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        for k in ("loss", "num_visible", "num_entries", "max_strip_entries"):
            out[k].append(float(m[k]))
        if it == 1:
            out["step1"] = {k: getattr(state.params, k).detach().cpu().clone() for k in PARAM_NAMES}
    out["launches"] = {k: LAUNCH_COUNTERS[k].launches for k in TRAIN_KERNELS}
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    out["denom"] = state.denom.cpu()
    out["rows"] = (mesh.rank * rows, (mesh.rank + 1) * rows)
    return out


def check_sharded(name, ranks, ref, exact):
    """Each rank's sharded steps against phase 5's single-device steps:
    every loss within rtol 1e-5, the rows after step 1 within atol 2e-5,
    one launch of each train-path kernel per step and rank, and the entry
    and visible counts of step 1 equal. With `exact` (one rank: one strip,
    the single-device sums) every step's counts and denom after the last
    are equal too. Over several strips a Gaussian's gradient is summed per
    strip and then over the ranks, which rounds otherwise than one sum, so
    from step 2 on a few rects can flip: the counts within 1e-5 of
    single-device's, and denom equal but on at most 1e-5 of the rows, by
    at most 1."""
    for r, got in enumerate(ranks):
        lo, hi = got["rows"]
        live = min(hi, len(ref["denom"])) - lo  # the rows past the model's are padding
        for it, (a, b) in enumerate(zip(got["loss"], ref["loss"]), 1):
            if not (math.isfinite(a) and abs(a - b) <= 1e-5 * abs(b)):
                fail(f"{name} rank {r}: step {it} loss {a} vs single-device {b}")
        apart = {}
        for k in ("num_visible", "num_entries"):
            d = [abs(a - b) for a, b in zip(got[k], ref[k])]
            apart[k] = max(d)
            if d[0] or (exact and any(d)) or any(x > 1e-5 * b for x, b in zip(d, ref[k])):
                fail(f"{name} rank {r}: {k} {got[k]} vs single-device {ref[k]}")
        worst = max(float((got["step1"][k][:live] - ref["step1"][k][lo:hi]).abs().max())
                    for k in PARAM_NAMES)
        if worst > 2e-5:
            fail(f"{name} rank {r}: parameters after step 1 off by {worst:.3e}")
        dd = (got["denom"][:live] - ref["denom"][lo:hi]).abs()
        n_diff = int((dd > 0).sum())
        if (exact and n_diff) or n_diff > 1e-5 * live or float(dd.max()) > 1:
            fail(f"{name} rank {r}: denom differs on {n_diff} rows (by up to {float(dd.max())})")
        if any(n != STEPS for n in got["launches"].values()):
            fail(f"{name} rank {r}: launches {got['launches']} for {STEPS} steps")
        print(f"  {name} rank {r} (rows {lo}..{hi}): {STEPS} losses within rtol 1e-5 of the "
              f"single-device steps ({got['loss'][0]:.6f} -> {got['loss'][-1]:.6f}); step 1's "
              f"counts equal, later ones at most {apart['num_entries']:.0f} entries and "
              f"{apart['num_visible']:.0f} visible apart; rows after step 1 within {worst:.2e}; "
              f"denom differs on {n_diff} rows; launches {got['launches']}; largest strip "
              f"{int(max(got['max_strip_entries']))} entries; peak device memory "
              f"{got['peak_mib']:.1f} MiB")
    return {k: sum(g["launches"][k] for g in ranks) for k in TRAIN_KERNELS}


def sharded_trainer_cloud():
    """SHARDED_TRAINER_POINTS of trained_r5's centres (a seeded random
    subset), coloured by the DC term; phase 5b's cameras and extent."""
    model = load_gaussians_ply(TRAINED_PLY)
    keep = np.sort(np.random.default_rng(0).permutation(len(model["xyz"]))[:SHARDED_TRAINER_POINTS])
    colors = np.clip(0.5 + gsmath.SH_C0 * model["features_dc"][:, 0, :], 0.0, 1.0)
    cams, extent = trainer_cameras(model["xyz"])
    return model["xyz"][keep], colors[keep].astype(np.float32), cams, extent


def new_sharded_trainer(cams, extent, mesh=None):
    return Trainer(cameras=cams, opt=SHARDED_TRAINER_OPT,
                   raster_cfg=RasterizerConfig(tile_w=32, tile_h=32), sh_degree=3,
                   cameras_extent=extent, spatial_lr_scale=extent, seed=0, mesh=mesh)


def sharded_trainer(mesh, tmp):
    """Trainer(mesh=...) for SHARDED_TRAINER_STEPS steps from the subset
    cloud. Returns its history, maintenance, live counts and launches; rank
    0 writes a checkpoint and renders camera 0 of the gathered state."""
    pts, cols, cams, extent = sharded_trainer_cloud()
    tr = new_sharded_trainer(cams, extent, mesh)
    tr.init_from_pcd(pts, cols)
    reset_launches()
    top_after_reset = None
    for _ in range(SHARDED_TRAINER_STEPS):
        tr.step()
        if tr.iteration == SHARDED_TRAINER_OPT.opacity_reset_interval:
            p = tr.state.params
            local = torch.sigmoid(p.opacity.detach()[:, 0]).masked_fill(~p.alive, 0).max()
            top_after_reset = float(sharding.gather_rows(local[None], mesh).max())
    launches = {k: LAUNCH_COUNTERS[k].launches for k in TRAIN_KERNELS}
    out = {"loss": [h["loss"] for h in tr.history], "densify": tr.densify_history,
           "num_live": tr.num_live, "local_live": int(tr.state.params.alive.sum()),
           "rows": tr.num_rows, "launches": launches, "top_after_reset": top_after_reset}
    whole = sharding.gather_train_state(tr.state, mesh)
    tr.save_checkpoint(os.path.join(tmp, "sharded.pkl"))  # every rank calls; rank 0 writes
    if mesh.rank == 0:
        arr, p = cams[0].arrays(), whole.params
        with torch.no_grad():
            n = int(preprocess(*activate(p), 3, arr, W_MAIN, H_MAIN, 32, 32,
                               alive=p.alive).tiles_touched.sum())
        cap = entry_bucket_capacity(n, 16, 1.2)
        img, aux = eval_render(p, arr, tr.background, 3, W_MAIN, H_MAIN,
                               RasterizerConfig(capacity_exact=cap))
        out["render"] = (img.cpu(), aux["final_t"].cpu(), cap)
    return out


def rank_main(rank, world, port, tmp, capacity):
    """One rank of the gloo run (a spawned process; both ranks on cuda:0):
    phase 5's steps sharded, then the sharded Trainer. Writes its results
    to tmp/rank<r>.pt."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sharding.initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo")
    try:
        mesh = sharding.make_mesh(world)
        gt, center, dist_ = torch.load(os.path.join(tmp, "target.pt"), weights_only=False)
        cam = orbit_camera(center, dist_, 0.0, W_MAIN, H_MAIN, 70.0, 70.0 * H_MAIN / W_MAIN).arrays()
        res = {"steps": sharded_steps(mesh, gt.to(dev), cam, capacity),
               "trainer": sharded_trainer(mesh, tmp)}
        torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        torch_dist.destroy_process_group()


def sharded_phase(dev, gt, center, dist_, capacity, ref, bare_step_ms):
    """Phase 5d: the kernels at a row origin; phase 5's steps on 2 ranks of
    one card (gloo) and on a one-rank NCCL group; the sharded Trainer on the
    2 ranks. Returns the launches of each path and the max abs errors of
    the three kernels at the strips."""
    t_phase = time.perf_counter()
    bg0 = torch.zeros(3, device=dev)
    cam = orbit_camera(center, dist_, 0.0, W_MAIN, H_MAIN, 70.0, 70.0 * H_MAIN / W_MAIN).arrays()
    with torch.no_grad():
        acts = tuple(activate(params_from_ply(TRAINED_PLY)))
        args, _, _ = sorted_inputs(acts, cam, W_MAIN, H_MAIN, (32, 32))
        full = composite_fwd_cuda(*args, bg0, W_MAIN, H_MAIN, 32, 32)
    errs = check_strips(acts, cam, bg0, full)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    try:
        torch.save((gt.cpu(), center, dist_), os.path.join(tmp, "target.pt"))
        ctx = mp.get_context("spawn")
        port = free_port()
        procs = [ctx.Process(target=rank_main, args=(r, RANKS, port, tmp, capacity))
                 for r in range(RANKS)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = t0 + RANK_TIMEOUT
        for p in procs:
            p.join(max(deadline - time.perf_counter(), 1.0))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.terminate()
            p.join(10)
        if alive or any(p.exitcode != 0 for p in procs):
            fail(f"sharded path: rank processes exited {[p.exitcode for p in procs]}"
                 f"{' (timed out)' if alive else ''}")
        ranks_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(RANKS)]
        print(f"sharded path: {RANKS} ranks on one card over gloo (host-staged), each its own "
              f"process, {ranks_s:.1f} s wall for both runs")
        launches_2 = check_sharded("2 ranks, gloo", [r["steps"] for r in ranks], ref, False)
        med = [float(np.median(r["steps"]["ms"][-TIMED_STEPS:])) for r in ranks]
        print(f"  sharded step median {', '.join(f'{m:.3f}' for m in med)} ms (ranks 0, 1; last "
              f"{TIMED_STEPS} steps, host clock) beside phase 5's single-device {bare_step_ms:.3f} ms: "
              f"2 ranks on one card, host-staged gloo; not a scaling figure")
        launches_trainer = check_sharded_trainer([r["trainer"] for r in ranks], tmp, dev)

        # The same steps on a one-rank NCCL group, in this process.
        sharding.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
        try:
            one = sharded_steps(sharding.make_mesh(1), gt, cam, capacity)
        finally:
            torch_dist.destroy_process_group()
        launches_1 = check_sharded("1 rank, NCCL", [one], ref, True)
        print(f"  one-rank NCCL step median {np.median(one['ms'][-TIMED_STEPS:]):.3f} ms (last "
              f"{TIMED_STEPS} steps, host clock) beside phase 5's single-device {bare_step_ms:.3f} ms")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"sharded_2rank": launches_2, "sharded_trainer": launches_trainer,
            "sharded_nccl1": launches_1}, errs


def check_sharded_trainer(ranks, tmp, dev):
    """The sharded Trainer's run: finite losses that fall, equal live counts
    on every rank, a device densify and a host densify that grew the rows,
    the reset, one launch of each kernel per step and rank; step 1 equal to
    the single-device Trainer's; rank 0's checkpoint in a single-device
    Trainer renders within the forward's rule of rank 0's own render."""
    r0 = ranks[0]
    losses_ = r0["loss"]
    first20, last20 = float(np.mean(losses_[:20])), float(np.mean(losses_[-20:]))
    if not all(math.isfinite(x) for x in losses_) or not last20 < first20:
        fail(f"sharded trainer: losses first 20 {first20}, last 20 {last20}")
    if len({r["num_live"] for r in ranks}) != 1 or sum(r["local_live"] for r in ranks) != r0["num_live"]:
        fail(f"sharded trainer: live counts {[(r['num_live'], r['local_live']) for r in ranks]}")
    paths = [d["path"] for d in r0["densify"]]
    grew = [d for d in r0["densify"] if d["path"] == "host" and d["capacity"] > d["rows_before"]]
    if "device" not in paths or not grew:
        fail(f"sharded trainer: densify paths {paths}; a device densify and a host densify that "
             f"grew the rows are both needed")
    if r0["top_after_reset"] is None or r0["top_after_reset"] > 0.01:
        fail(f"sharded trainer: a live opacity of {r0['top_after_reset']} after the reset")
    for r, got in enumerate(ranks):
        if any(n != SHARDED_TRAINER_STEPS for n in got["launches"].values()):
            fail(f"sharded trainer rank {r}: launches {got['launches']}")

    pts, cols, cams, extent = sharded_trainer_cloud()
    one = new_sharded_trainer(cams, extent)
    one.init_from_pcd(pts, cols)
    saved = {k: LAUNCH_COUNTERS[k].launches for k in TRAIN_KERNELS}
    first = one.step()["loss"]
    if abs(first - losses_[0]) > 1e-5 * abs(first):
        fail(f"sharded trainer: step 1 loss {losses_[0]} vs the single-device Trainer's {first}")
    back = new_sharded_trainer(cams, extent)
    back.load_checkpoint(os.path.join(tmp, "sharded.pkl"))
    if back.num_live != r0["num_live"] or back.iteration != SHARDED_TRAINER_STEPS:
        fail(f"sharded trainer: the checkpoint gave {back.num_live} live rows at {back.iteration}")
    img, final_t, cap = r0["render"]
    mine = eval_render(back.state.params, cams[0].arrays(), back.background, 3, W_MAIN, H_MAIN,
                       RasterizerConfig(capacity_exact=cap))
    torch.cuda.synchronize()
    compare("sharded trainer checkpoint, single device", CompositeOut(mine[0].cpu(),
            mine[1]["final_t"].cpu()), CompositeOut(img, final_t), 1e-5)
    for k, n in saved.items():  # these launches are not the path's
        LAUNCH_COUNTERS[k].launches = n
    print(f"  sharded trainer: {SHARDED_TRAINER_STEPS} steps on {len(ranks)} ranks from "
          f"{len(pts)} points, loss {losses_[0]:.6f} -> {losses_[-1]:.6f} (first 20 {first20:.6f}, "
          f"last 20 {last20:.6f}); step 1 within rtol 1e-5 of the single-device Trainer's "
          f"({first:.6f}); live {r0['num_live']} of {r0['rows']} rows on every rank "
          f"({[r['local_live'] for r in ranks]} per shard); densifies {paths} (host at "
          f"{[d['iteration'] for d in grew]}, rows {grew[0]['rows_before']} -> "
          f"{grew[0]['capacity']}); max opacity after the reset {r0['top_after_reset']:.5f}; "
          f"launches per rank {[r['launches'] for r in ranks]}; rank 0's checkpoint renders "
          f"within the forward's rule in a single-device Trainer")
    return {k: sum(r["launches"][k] for r in ranks) for k in TRAIN_KERNELS}


# ---- phase 5f: the bench ----------------------------------------------------

def bench_metric(mode, env):
    """The metric bench_torch.py must name for a run of BENCH_RUNS."""
    scene = env.get("GS_BENCH_SCENE", "ply")
    P = 122_535 if scene == "ply" else 262_144
    kind = "train_its" if mode == "train" else "render_fps"
    return f"{kind}_{W_MAIN}x{H_MAIN}_P{P}_cuda" + ("" if scene == "cloud" else f"_{scene}")


def bench_env(env):
    """This process's environment with no GS_BENCH_* but `env`'s and
    GS_BENCH_ITERS = BENCH_ITERS."""
    out = {k: v for k, v in os.environ.items() if not k.startswith("GS_BENCH_")}
    return {**out, **env, "GS_BENCH_ITERS": str(BENCH_ITERS)}


def bench_in_process(env):
    """`cli.bench.main` in this process with `env`'s settings (its JSON line
    kept out of this script's output); returns its result and each
    train-path kernel's launches, read after a reset."""
    saved = {k: v for k, v in os.environ.items() if k.startswith("GS_BENCH_")}
    for k in saved:
        del os.environ[k]
    os.environ.update(env, GS_BENCH_ITERS=str(BENCH_ITERS))
    try:
        reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            result = bench_cli.main([])
        return result, {k: LAUNCH_COUNTERS[k].launches for k in TRAIN_KERNELS}
    finally:
        for k in [k for k in os.environ if k.startswith("GS_BENCH_")]:
            del os.environ[k]
        os.environ.update(saved)


def bench_phase(dev):
    """Phase 5f (module docstring). Returns the launches of the in-process
    runs summed per kernel and the max abs errors of the three train-path
    kernels at the bench's inputs."""
    t_phase = time.perf_counter()
    print("bench path:")
    for name, env in BENCH_RUNS:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py")], cwd=ROOT,
                              env=bench_env(env), capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"bench_torch.py {name} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
        lines = proc.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            fail(f"bench_torch.py {name}: last line {lines[-1:]} is not JSON")
        want = bench_metric(env["GS_BENCH_MODE"], env)
        if result.get("metric") != want:
            fail(f"bench_torch.py {name}: metric {result.get('metric')!r}, expected {want!r}")
        value = result.get("value")
        if not isinstance(value, (int, float)) or not math.isfinite(value) or value <= 0:
            fail(f"bench_torch.py {name}: value {value!r}")
        info = [ln for ln in proc.stderr.splitlines() if ln.startswith("# ")]
        print(f"  bench_torch.py {name}: {result['metric']} = {value} {result['unit']} "
              f"(vs_baseline {result['vs_baseline']}), frame median {result['frame_ms_median']:.3f} "
              f"ms, p80 {result['frame_ms_p80']:.3f} ms; process wall {wall:.1f} s; {info[-1:]}")

    launches = {k: 0 for k in TRAIN_KERNELS}
    for name, env in BENCH_RUNS:
        result, counts = bench_in_process(env)
        per_chain = 4 * BENCH_ITERS
        want = {k: per_chain if env["GS_BENCH_MODE"] == "train" or k == "composite_fwd" else 0
                for k in TRAIN_KERNELS}
        if counts != want:
            fail(f"bench in process {name}: launches {counts}, expected {want}")
        for k in TRAIN_KERNELS:
            launches[k] += counts[k]
        print(f"  in process {name}: {result['value']} {result['unit']}, launches {counts}")

    # The kernels at the bench's own inputs: the trained model at 1080p, its
    # render camera (the forward) and its train state and camera (all three).
    sc = bench_cli.bench_scene("ply", 0, None)
    acts = tuple(torch.as_tensor(x, device=dev) for x in sc[:5])
    rcam = bench_cli.bench_camera(W_MAIN, H_MAIN, sc.cam_dist, dev)
    tcam = bench_cli.bench_camera(W_MAIN, H_MAIN, 4.0, dev)
    params = bench_cli.bench_train_params(sc, dev)
    bg = torch.zeros(3, device=dev)
    gt = torch.as_tensor(np.random.default_rng(1).uniform(size=(H_MAIN, W_MAIN, 3)),
                         dtype=torch.float32, device=dev)
    errs = {k: 0.0 for k in TRAIN_KERNELS}
    for tile in ((32, 32), (8, 8)):
        name = f"bench {tile[0]}x{tile[1]}"
        capacity, _ = bench_cli.bench_capacity(acts, rcam, W_MAIN, H_MAIN, *tile)
        with torch.no_grad():
            args, _, total = sorted_inputs(acts, rcam, W_MAIN, H_MAIN, tile, capacity=capacity)
            out = composite_fwd_cuda(*args, bg, W_MAIN, H_MAIN, *tile)
            ref = composite_fwd_torch(*args, bg, W_MAIN, H_MAIN, *tile)
        torch.cuda.synchronize()
        errs["composite_fwd"] = max(errs["composite_fwd"],
                                    compare(f"{name} render K={total}", out, ref, 1e-5))
        check_cull(f"{name} render", out, args, bg, W_MAIN, H_MAIN, tile)
        fwd_ms = cuda_time_ms(lambda: composite_fwd_cuda(*args, bg, W_MAIN, H_MAIN, *tile), 20)
        for k, e in zip(TRAIN_KERNELS, check_state(f"{name} train state", params, 3, tcam, bg,
                                                    capacity, tile, seed=40)):
            errs[k] = max(errs[k], e)
        # the backward at the train state's first step: the loss's cotangent
        with torch.no_grad():
            targs, tlists, _ = sorted_inputs(tuple(activate(params)), tcam, W_MAIN, H_MAIN, tile,
                                             capacity=capacity)
            fwd = composite_fwd_cuda(*targs, bg, W_MAIN, H_MAIN, *tile)
        img = fwd.image.clone().requires_grad_(True)
        loss = 0.8 * losses.l1_loss(img, gt) + 0.2 * (1 - losses.ssim(img, gt))
        (g_img,) = torch.autograd.grad(loss, [img])
        bargs = (*targs[:3], tlists.entry_src, *targs[3:], fwd.image, fwd.final_t, g_img,
                 torch.zeros_like(fwd.final_t), W_MAIN, H_MAIN, *tile)
        bwd_ms = cuda_time_ms(lambda: composite_bwd_cuda(*bargs), 20)
        occ = composite_fwd_occupancy(*tile, dev.index), composite_bwd_occupancy(*tile, dev.index)
        print(f"  {name}: forward {fwd_ms:.4f} ms at the render camera (K={total}), backward "
              f"{bwd_ms:.4f} ms at the train state (K={int(tlists.total)}); registers / threads / "
              f"blocks per SM: forward {occ[0]['registers']} / {occ[0]['threads']} / "
              f"{occ[0]['blocks_per_sm']}, backward {occ[1]['registers']} / {occ[1]['threads']} / "
              f"{occ[1]['blocks_per_sm']}")
    print(f"  phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches, errs


# ---- LPIPS ---------------------------------------------------------------

LPIPS_NETS = ("vgg", "alex", "squeeze")
_VGG_STAGES = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
_ALEX_CONVS = [(3, 64, 11), (64, 192, 5), (192, 384, 3), (384, 256, 3), (256, 256, 3)]
_SQ_FIRES = [(64, 16, 64), (128, 16, 64), (128, 32, 128), (256, 32, 128),
             (256, 48, 192), (384, 48, 192), (384, 64, 256), (512, 64, 256)]
_SQ_CH = [64, 128, 256, 384, 384, 512, 512]


def lpips_random_weights(seed=11):
    """Seeded random weights of all three backbones, with the shapes of
    tests/test_lpips.py::make_random_weights and its alex and squeeze
    analogs (He-scaled convs, small biases, heads uniform in [0, 0.2])."""
    rng = np.random.default_rng(seed)

    def conv(ic, oc, k):
        return (rng.normal(0, np.sqrt(2.0 / (ic * k * k)), (oc, ic, k, k)).astype(np.float32),
                rng.normal(0, 0.02, oc).astype(np.float32))

    out, in_c, ci = {}, 3, 0
    for out_c, n_convs in _VGG_STAGES:
        for _ in range(n_convs):
            out[f"conv{ci}_w"], out[f"conv{ci}_b"] = conv(in_c, out_c, 3)
            in_c, ci = out_c, ci + 1
    for j, (out_c, _) in enumerate(_VGG_STAGES):
        out[f"lin{j}_w"] = rng.uniform(0.0, 0.2, out_c).astype(np.float32)
    for i, (ic, oc, k) in enumerate(_ALEX_CONVS):
        out[f"alex_conv{i}_w"], out[f"alex_conv{i}_b"] = conv(ic, oc, k)
        out[f"alex_lin{i}_w"] = rng.uniform(0.0, 0.2, oc).astype(np.float32)
    out["sq_conv0_w"], out["sq_conv0_b"] = conv(3, 64, 3)
    for f, (ic, sq, e) in enumerate(_SQ_FIRES):
        out[f"sq{f}_s_w"], out[f"sq{f}_s_b"] = conv(ic, sq, 1)
        out[f"sq{f}_e1_w"], out[f"sq{f}_e1_b"] = conv(sq, e, 1)
        out[f"sq{f}_e3_w"], out[f"sq{f}_e3_b"] = conv(sq, e, 3)
    for j, c in enumerate(_SQ_CH):
        out[f"sq_lin{j}_w"] = rng.uniform(0.0, 0.2, c).astype(np.float32)
    return out


def lpips_phase(img_a, img_b):
    """LPIPS of two 1080p renders of trained_r5 on the card, per backbone:
    float32 within rel 1e-4 of float64 (weights of the .npz named by
    GS_TPU_LPIPS_WEIGHTS); ms per pair in float32 (CUDA events)."""
    for net in LPIPS_NETS:
        if not lpips_mod.lpips_available(net):
            fail(f"lpips: no {net} weights")
        d32 = float(lpips_mod.lpips(img_a, img_b, net))
        d64 = float(lpips_mod.lpips(img_a.double(), img_b.double(), net))
        torch.cuda.synchronize()
        if not (math.isfinite(d32) and abs(d32 - d64) <= 1e-4 * abs(d64) and d64 > 0):
            fail(f"lpips {net}: float32 {d32} vs float64 {d64}")
        ms = cuda_time_ms(lambda: lpips_mod.lpips(img_a, img_b, net), 3)
        print(f"  lpips {net} (seeded random weights) at {W_MAIN}x{H_MAIN}: {d32:.7f}, float64 "
              f"{d64:.7f} (rel {abs(d32 - d64) / d64:.2e}); {ms:.2f} ms per pair in float32 "
              f"(CUDA events, TF32 off)")
    lpips_mod._load_weights.cache_clear()  # free the float64 copies on the card


def main():
    phase_t0 = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        print(f"phase {name}: {now - phase_t0[0]:.1f} s wall", flush=True)
        phase_t0[0] = now

    # ---- 1. device ----------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this script runs on a GPU only")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"device: {kind} (torch sees {count}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(pil_versions())
    print(gpu_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_done("1 device")

    # ---- 2. build -----------------------------------------------------
    t0 = time.perf_counter()

    def build_host():
        cuda_build.build_host()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(1) as pool:  # the host sources beside the kernels' nvccs
        host_s = pool.submit(build_host)
        logs = cuda_build.build()
        print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s; host sources "
              f"{cuda_build.host_sources()} (c++) in {host_s.result():.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "smem", "Compiling entry")):
                print(f"  ptxas[{name}]: {line.strip()}")
    phase_done("2 build")

    # ---- 3. kernels vs plain ------------------------------------------
    print("kernels vs plain:")
    max_err = {"composite_fwd": 0.0, "composite_bwd": 0.0, "route_grads": 0.0}

    def note_bwd(errs):
        max_err["composite_bwd"] = max(max_err["composite_bwd"], errs[0])
        max_err["route_grads"] = max(max_err["route_grads"], errs[1])

    for seed, (W, H) in enumerate([(128, 128), (333, 197)]):
        scene = [torch.from_numpy(x).to(dev) for x in make_gaussians(P=3000, seed=seed)]
        cam = orbit_camera((0, 0, 0), 4.0, 0.3 * seed, W, H, 60.0, 60.0 * H / W).arrays()
        for tile in TILE_GEOMETRIES:
            name = f"random {W}x{H} tile {tile[0]}x{tile[1]}"
            args, lists, _ = sorted_inputs(scene, cam, W, H, tile)
            bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
            out = composite_fwd_cuda(*args, bg, W, H, *tile)
            ref = composite_fwd_torch(*args, bg, W, H, *tile)
            torch.cuda.synchronize()
            max_err["composite_fwd"] = max(max_err["composite_fwd"], compare(name, out, ref, 1e-5))
            check_cull(name, out, args, bg, W, H, tile)
            note_bwd(check_backward(name, args, lists, bg, W, H, tile, seed=10 + seed))
    for tile in TILE_GEOMETRIES:  # near-singular conics, 75x53 (a multiple of no tile side)
        name = f"thin splats 75x53 tile {tile[0]}x{tile[1]}"
        args = thin_splats_everywhere(dev, 75, 53, tile, seed=6)
        bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
        out = composite_fwd_cuda(*args, bg, 75, 53, *tile)
        ref = composite_fwd_torch(*args, bg, 75, 53, *tile)
        torch.cuda.synchronize()
        max_err["composite_fwd"] = max(max_err["composite_fwd"], compare(name, out, ref, 1e-5))
        check_cull(name, out, args, bg, 75, 53, tile)

    params = params_from_ply(TRAINED_PLY)  # device defaults to the card
    with torch.no_grad():
        acts = tuple(activate(params))
    xyz = params.xyz.detach().cpu().numpy()
    center = xyz.mean(axis=0)
    dist = 2.5 * float(np.quantile(np.linalg.norm(xyz - center, axis=1), 0.95))
    cams = [orbit_camera(center, dist, a, W_MAIN, H_MAIN, 70.0, 70.0 * H_MAIN / W_MAIN)
            for a in (0.0, 2.1, 4.2)]
    bg0 = torch.zeros(3, device=dev)
    with torch.no_grad():
        for i, cam in enumerate(cams):
            name = f"trained 1080p angle {i}"
            args, lists, total = sorted_inputs(acts, cam.arrays(), W_MAIN, H_MAIN, (32, 32))
            out = composite_fwd_cuda(*args, bg0, W_MAIN, H_MAIN, 32, 32)
            ref = composite_fwd_torch(*args, bg0, W_MAIN, H_MAIN, 32, 32)
            torch.cuda.synchronize()
            max_err["composite_fwd"] = max(max_err["composite_fwd"],
                                           compare(f"{name} K={total}", out, ref, 1e-5))
            check_cull(name, out, args, bg0, W_MAIN, H_MAIN, (32, 32))
            if i == 0:
                main_args = args
                note_bwd(check_backward(name, args, lists, bg0, W_MAIN, H_MAIN, (32, 32), seed=20))

    golden = make_gaussians(P=300, seed=5, spread=0.9)
    gcam = orbit_camera((0, 0, 0), 4.0, 0.0, 128, 128, 60.0, 60.0).arrays()
    img, aux = rasterize(*[torch.from_numpy(x).to(dev) for x in golden], 3, gcam, 128, 128,
                         [0.1, 0.2, 0.3], RasterizerConfig(capacity_mult=32))
    fixture = CompositeOut(*(torch.from_numpy(np.load(os.path.join(FIXTURES, f)))
                             for f in ("golden_render_128.npy", "golden_final_t_128.npy")))
    compare("golden 128x128 vs fixture", CompositeOut(img.cpu(), aux["final_t"].cpu()), fixture, 2e-5)
    max_err.update(check_transpose_and_sums(dev))
    phase_done("3 kernels vs plain")

    # ---- 4. render path -----------------------------------------------
    cam = cams[0].arrays()
    with torch.no_grad():
        prep = preprocess(*acts, 3, cam, W_MAIN, H_MAIN, 32, 32)
        n_entries = int(prep.tiles_touched.sum())
    # as bench.py: 2% headroom, snapped to 2^16-entry buckets
    capacity = entry_bucket_capacity(n_entries, bits=16, headroom=1.02)
    cfg = RasterizerConfig(capacity_exact=capacity)
    for _ in range(2):  # warm-up
        eval_render(params, cam, bg0, 3, W_MAIN, H_MAIN, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    frame_times = []
    reset_launches()
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        img, aux = eval_render(params, cam, bg0, 3, W_MAIN, H_MAIN, cfg)
        torch.cuda.synchronize()
        frame_times.append((time.perf_counter() - t0) * 1e3)
    launches = composite_fwd.launches
    render0 = img.clamp(0.0, 1.0)  # for phase 5c's LPIPS
    frame_ms, frame_p80 = np.median(frame_times), np.percentile(frame_times, 80)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    if launches != FRAMES or composite_bwd.launches or route_grads.launches:
        fail(f"render path launched the compositing kernels {launches} / {composite_bwd.launches}"
             f" / {route_grads.launches} times for {FRAMES} frames")
    if tuple(img.shape) != (H_MAIN, W_MAIN, 3) or not bool(torch.isfinite(img).all()):
        fail("render path image has the wrong shape or is not finite")
    covered = float((img.amax(dim=-1) > 0.05).float().mean())
    if covered < 0.01:
        fail(f"render path image is background ({covered:.2%} of pixels covered)")
    if int(aux["num_entries"]) != n_entries or n_entries > capacity:
        fail(f"entry count {int(aux['num_entries'])} vs {n_entries}, capacity {capacity}")
    print(f"render path: trained_r5.ply P={params.num_points} at {W_MAIN}x{H_MAIN}, "
          f"K={n_entries} entries (capacity {capacity}), {covered:.1%} of pixels covered")
    print(f"  frame latency median {frame_ms:.3f} ms, p80 {frame_p80:.3f} ms "
          f"({FRAMES} frames, host clock, each ending in a synchronize; "
          f"{1e3 / frame_ms:.1f} frames/s at the median); compositing launches {launches}; "
          f"peak device memory {peak_mib:.1f} MiB")
    stages = stage_times_ms(params, cam, bg0, cfg)
    print("  stages run alone (host clock, synchronized, median): "
          + ", ".join(f"{n} {t:.3f} ms" for n, t in stages.items()))
    print_busy(*device_busy_ms(lambda: eval_render(params, cam, bg0, 3, W_MAIN, H_MAIN, cfg)),
               frame_ms, "frame")

    fwd_ms = cuda_time_ms(lambda: composite_fwd_cuda(*main_args, bg0, W_MAIN, H_MAIN, 32, 32), 20)
    fwd_plain_ms = cuda_time_ms(lambda: composite_fwd_torch(*main_args, bg0, W_MAIN, H_MAIN, 32, 32), 2)
    fcounts = blend_pair_counts(*main_args, W_MAIN, H_MAIN, 32, 32)
    P, T = params.num_points, main_args[1].shape[0]
    # each input read once (ids, 9 float fields per Gaussian, tile ranges, bg),
    # each output written once (image + final_t)
    nbytes = 4 * n_entries + 36 * P + 8 * T + 12 + 16 * W_MAIN * H_MAIN
    fwd_bound = bound_ms(nbytes, pair_ops(fcounts.pairs, fcounts.taken))
    fwd_every_pair = bound_ms(nbytes, OPS_PER_PAIR * fcounts.pairs)[0]
    fwd_occ = composite_fwd_occupancy(32, 32, dev.index)
    print(f"  kernel {fwd_ms:.4f} ms, plain {fwd_plain_ms:.2f} ms; pairs {fcounts.pairs}, taken "
          f"{fcounts.taken}, bytes {nbytes}: {fwd_bound[2]}; {fwd_every_pair:.4f} ms with every "
          f"evaluated pair at {OPS_PER_PAIR} operations")
    print(f"  kernel at 32x32: {fcounts.units} (entry, 32-pixel unit) pairs with an open pixel "
          f"in the entry's box, {fwd_occ['registers']} registers per thread, "
          f"{fwd_occ['threads']} threads per block, {fwd_occ['blocks_per_sm']} resident blocks per SM")
    phase_done("4 render path")

    # ---- 5. train path ------------------------------------------------
    opt = OptimizationConfig()
    with torch.no_grad():  # the target: the model's own render from angle 0.2 rad
        tcam = orbit_camera(center, dist, 0.2, W_MAIN, H_MAIN, 70.0, 70.0 * H_MAIN / W_MAIN).arrays()
        t_entries = int(preprocess(*acts, 3, tcam, W_MAIN, H_MAIN, 32, 32).tiles_touched.sum())
        gt = eval_render(params, tcam, bg0, 3, W_MAIN, H_MAIN,
                         RasterizerConfig(capacity_exact=entry_bucket_capacity(t_entries, 16, 1.2))
                         )[0].clamp(0.0, 1.0)
    del params, acts
    train_capacity = entry_bucket_capacity(n_entries, 16, 1.2)
    tcfg = RasterizerConfig(capacity_exact=train_capacity)
    state = init_train_state(params_from_ply(TRAINED_PLY))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_times, step_losses, step_entries, step_visible = [], [], [], []
    reset_launches()
    for it in range(1, STEPS + 1):
        t0 = time.perf_counter()
        m = train_step(state, cam, gt, bg0, it, 3, W_MAIN, H_MAIN, tcfg, opt, spatial_lr_scale=1.0)
        torch.cuda.synchronize()
        step_times.append((time.perf_counter() - t0) * 1e3)
        step_losses.append(float(m["loss"]))
        step_entries.append(int(m["num_entries"]))
        step_visible.append(int(m["num_visible"]))
        if it == 1:  # phase 5d's reference
            step1 = {k: getattr(state.params, k).detach().cpu().clone() for k in PARAM_NAMES}
    # phase 5d holds the sharded steps to these
    single_ref = {"loss": step_losses, "num_entries": [float(x) for x in step_entries],
                  "num_visible": [float(x) for x in step_visible], "step1": step1,
                  "denom": state.denom.cpu().clone()}
    train_launches = {"composite_fwd": composite_fwd.launches,
                      "composite_bwd": composite_bwd.launches, "route_grads": route_grads.launches}
    train_peak_mib = torch.cuda.max_memory_allocated() / 2**20
    if any(n != STEPS for n in train_launches.values()):
        fail(f"train path launches {train_launches} for {STEPS} steps")
    if max(step_entries) > train_capacity:
        fail(f"train path entry count {max(step_entries)} over capacity {train_capacity}")
    if not all(math.isfinite(x) for x in step_losses):
        fail(f"train path loss not finite: {step_losses}")
    if not step_losses[-1] < step_losses[0]:
        fail(f"train path loss did not fall: step 1 {step_losses[0]}, step {STEPS} {step_losses[-1]}")
    timed = step_times[-TIMED_STEPS:]
    step_ms, step_p80 = float(np.median(timed)), float(np.percentile(timed, 80))
    print(f"train path: trained_r5.ply P={state.params.num_points} at {W_MAIN}x{H_MAIN}, "
          f"{STEPS} steps toward the render from 0.2 rad, K={step_entries[0]}..{max(step_entries)} "
          f"entries (capacity {train_capacity}); loss {step_losses[0]:.6f} -> {step_losses[-1]:.6f}, "
          f"psnr {float(m['psnr']):.3f} dB at step {STEPS}; launches {train_launches}")
    print(f"  step latency median {step_ms:.3f} ms, p80 {step_p80:.3f} ms (last {TIMED_STEPS} of "
          f"{STEPS} steps, host clock, each ending in a synchronize; {1e3 / step_ms:.1f} steps/s "
          f"at the median); peak device memory {train_peak_mib:.1f} MiB")
    print("  losses: " + " ".join(f"{x:.6f}" for x in step_losses))

    iteration = [STEPS]  # the profiled steps continue the schedule

    def one_step():
        iteration[0] += 1
        train_step(state, cam, gt, bg0, iteration[0], 3, W_MAIN, H_MAIN, tcfg, opt,
                   spatial_lr_scale=1.0)

    stages = train_stage_times_ms(state, cam, gt, bg0, tcfg, opt)
    print("  stages run alone (stream time, CUDA events, synchronized, median): "
          + ", ".join(f"{n} {t:.3f} ms" for n, t in stages.items()))
    print_busy(*device_busy_ms(one_step, reps=3), step_ms, "step")

    # The backward and routing kernels at the train path's own inputs: the
    # state after the steps above, the loss's image cotangent, no final_t one.
    with torch.no_grad():
        a = activate(state.params)
        args, lists, n_kept = sorted_inputs(tuple(a), cam, W_MAIN, H_MAIN, (32, 32))
        fwd = composite_fwd_cuda(*args, bg0, W_MAIN, H_MAIN, 32, 32)
    img = fwd.image.clone().requires_grad_(True)
    loss = (1 - opt.lambda_dssim) * losses.l1_loss(img, gt) + opt.lambda_dssim * (1 - losses.ssim(img, gt))
    (g_img,) = torch.autograd.grad(loss, [img])
    bargs = (*args[:3], lists.entry_src, *args[3:], fwd.image, fwd.final_t, g_img,
             torch.zeros_like(fwd.final_t), W_MAIN, H_MAIN, 32, 32)
    P = args[3].shape[0]
    off, cnt = lists.gauss_offset, lists.gauss_count
    rows = composite_bwd_cuda(*bargs)
    bwd_ms = cuda_time_ms(lambda: composite_bwd_cuda(*bargs), 20)
    bwd_plain_ms = cuda_time_ms(lambda: composite_bwd_torch(*bargs), 1)
    route_ms = cuda_time_ms(lambda: route_grads_cuda(rows, off, cnt, P), 50)
    route_plain_ms = cuda_time_ms(lambda: route_grads_torch(rows, off, cnt, P), 5)
    seg = torch.repeat_interleave(torch.arange(P, device=dev), cnt.long(), output_size=n_kept)
    src = rows[:n_kept]
    out9 = torch.zeros((P, 9), device=dev)
    index_add_ms = cuda_time_ms(lambda: out9.zero_().index_add_(0, seg, src), 50)

    bwd_occ = composite_bwd_occupancy(32, 32, dev.index)
    counts = blend_pair_counts(*args, W_MAIN, H_MAIN, 32, 32, warps=bwd_occ["threads"] // 32)
    pairs, taken, blended = counts.pairs, counts.taken, counts.blended
    T = args[1].shape[0]
    # each input read once: ids and emission indices of the kept entries,
    # 9 float fields per Gaussian, tile ranges, image + final_t + their
    # cotangents per pixel; each output written once: 9 floats per entry
    bwd_bytes = 8 * n_kept + 36 * P + 8 * T + 32 * W_MAIN * H_MAIN + 36 * n_kept
    bwd_bound = bound_ms(bwd_bytes, pair_ops(pairs, taken) + OPS_PER_BLENDED_BWD * blended)
    bwd_every_pair = bound_ms(bwd_bytes, OPS_PER_PAIR * pairs + OPS_PER_BLENDED_BWD * blended)[0]
    # rows of the kept entries read once, run bounds read, sums written; 9 adds per entry
    route_bytes = 36 * n_kept + 8 * P + 36 * P
    route_bound = bound_ms(route_bytes, 9 * n_kept)
    print(f"  backward kernel {bwd_ms:.4f} ms, plain {bwd_plain_ms:.2f} ms; K={n_kept}, pairs {pairs}, "
          f"taken {taken}, blended {blended}, bytes {bwd_bytes}: {bwd_bound[2]}; "
          f"{bwd_every_pair:.4f} ms with every evaluated pair at {OPS_PER_PAIR} operations")
    print(f"  backward kernel at 32x32: {counts.band_entries} (entry, warp band) reductions, "
          f"{counts.units} (entry, 32-pixel unit) pairs with an open pixel in the entry's box, "
          f"{bwd_occ['registers']} registers per thread, {bwd_occ['threads']} threads per block, "
          f"{bwd_occ['blocks_per_sm']} resident blocks per SM")
    runs = cnt.cpu().numpy()
    print(f"  routing kernel {route_ms:.4f} ms, plain {route_plain_ms:.3f} ms, index_add_ "
          f"{index_add_ms:.4f} ms; bytes {route_bytes}: {route_bound[2]}; entries per Gaussian: "
          f"max {runs.max()}, p99.9 {np.percentile(runs, 99.9):.1f}, median {np.median(runs):.0f}")
    phase_done("5 train path")

    # ---- 5b. trainer path ---------------------------------------------
    trainer_launches, trainer_err = trainer_phase(dev, step_ms)
    for k, e in trainer_err.items():
        max_err[k] = max(max_err[k], e)
    phase_done("5b trainer path")

    # ---- 5c. CLI path, with LPIPS on seeded random weights -------------
    lpips_dir = tempfile.mkdtemp(prefix="chip_smoke_lpips_")
    try:
        np.savez(os.path.join(lpips_dir, "lpips.npz"), **lpips_random_weights())
        os.environ["GS_TPU_LPIPS_WEIGHTS"] = os.path.join(lpips_dir, "lpips.npz")
        lpips_mod._load_weights.cache_clear()
        print("lpips:")
        lpips_phase(render0, gt)
        cli_train_launches, cli_render_launches, cli_errs = cli_phase(dev)
        phase_done("5c CLI path")
        # ---- 5e. Blender path (the metrics CLI's LPIPS on the same weights)
        blender_launches, blender_errs = blender_phase(dev)
        phase_done("5e Blender path")
        # ---- 5g. the user's commands (the metrics CLI's LPIPS on the same weights)
        user_train_launches, user_render_launches, user_errs = user_phase(dev)
        phase_done("5g user's commands")
        # ---- 5h. the legacy forms
        forms_train_launches, forms_errs = legacy_phase(dev)
    finally:
        os.environ.pop("GS_TPU_LPIPS_WEIGHTS", None)
        lpips_mod._load_weights.cache_clear()
        shutil.rmtree(lpips_dir, ignore_errors=True)
    for k, e in (*zip(TRAIN_KERNELS, cli_errs), *zip(TRAIN_KERNELS, blender_errs),
                 *zip(TRAIN_KERNELS, user_errs), *zip(TRAIN_KERNELS, forms_errs)):
        max_err[k] = max(max_err[k], e)
    phase_done("5h legacy forms")

    # ---- 5i. DDS --------------------------------------------------------
    dds_train_launches, dds_errs = dds_phase(dev)
    for k, e in zip(TRAIN_KERNELS, dds_errs):
        max_err[k] = max(max_err[k], e)
    phase_done("5i DDS")

    # ---- 5j. AVIF -------------------------------------------------------
    avif_train_launches, avif_errs = avif_phase(dev)
    for k, e in zip(TRAIN_KERNELS, avif_errs):
        max_err[k] = max(max_err[k], e)
    phase_done("5j AVIF")

    # ---- 5k. AVIF with CDEF and loop restoration ------------------------
    avif_filters_train_launches, avif_filters_errs = avif_filters_phase(dev)
    for k, e in zip(TRAIN_KERNELS, avif_filters_errs):
        max_err[k] = max(max_err[k], e)
    phase_done("5k AVIF filters")

    # ---- 5l. AVIF screen content: palette and IntraBC --------------------
    avif_screen_train_launches, avif_screen_errs = avif_screen_phase(dev)
    for k, e in zip(TRAIN_KERNELS, avif_screen_errs):
        max_err[k] = max(max_err[k], e)
    phase_done("5l AVIF screen content")

    # ---- 5m. AVIF film grain and image sequences ------------------------
    avif_grain_train_launches, avif_grain_errs = avif_grain_phase(dev)
    for k, e in zip(TRAIN_KERNELS, avif_grain_errs):
        max_err[k] = max(max_err[k], e)
    phase_done("5m AVIF film grain and sequences")

    # ---- 5n. JPEG arithmetic coding and lossless ------------------------
    jpeg_arith_train_launches, jpeg_arith_errs = jpeg_arith_phase(dev)
    for k, e in zip(TRAIN_KERNELS, jpeg_arith_errs):
        max_err[k] = max(max_err[k], e)
    phase_done("5n JPEG arithmetic and lossless")

    # ---- 5o. BLP, FTEX, GBR, FITS, FLI, ICNS, EPS and the stubs --------
    rare_forms_train_launches, rare_forms_errs = rare_forms_phase(dev)
    for k, e in zip(TRAIN_KERNELS, rare_forms_errs):
        max_err[k] = max(max_err[k], e)
    phase_done("5o BLP, FTEX, GBR, FITS, FLI, ICNS")

    # ---- 5p. IM, IMT, IPTC, McIDAS, MSP, PCD, PIXAR, SPIDER, SUN, XBM, XPM, XV
    pil_rest_train_launches, pil_rest_errs = pil_rest_phase(dev)
    for k, e in zip(TRAIN_KERNELS, pil_rest_errs):
        max_err[k] = max(max_err[k], e)
    phase_done("5p IM, IMT, IPTC, McIDAS, MSP, PCD, PIXAR, SPIDER, SUN, XBM, XPM, XV")

    # ---- 5q. AVIF grid images -------------------------------------------
    avif_grid_train_launches, avif_grid_errs = avif_grid_phase(dev)
    for k, e in zip(TRAIN_KERNELS, avif_grid_errs):
        max_err[k] = max(max_err[k], e)
    phase_done("5q AVIF grids")

    # ---- 5r. AVIF at 10 and 12 bits ---------------------------------------
    avif_hbd_train_launches, avif_hbd_errs = avif_hbd_phase(dev)
    for k, e in zip(TRAIN_KERNELS, avif_hbd_errs):
        max_err[k] = max(max_err[k], e)
    phase_done("5r AVIF at 10 and 12 bits")

    # ---- 5d. sharded path ---------------------------------------------
    sharded_launches, strip_errs = sharded_phase(dev, gt, center, dist, train_capacity,
                                                 single_ref, step_ms)
    for k, e in zip(TRAIN_KERNELS, strip_errs):
        max_err[k] = max(max_err[k], e)
    phase_done("5d sharded path")

    # ---- 5f. bench path -----------------------------------------------
    bench_launches, bench_errs = bench_phase(dev)
    for k, e in bench_errs.items():
        max_err[k] = max(max_err[k], e)
    phase_done("5f bench path")

    # ---- 6. profiler path ---------------------------------------------
    reset_launches()
    # comm's link rate: NVLink 4's published 450 GB/s per direction (H100 SXM
    # data sheet), a specification, not a measurement
    os.environ["GS_LINK_GBPS"] = "450"
    try:
        prof = profile_stages.run(profile_stages.STAGES)  # the tool's defaults, on the card
    finally:
        os.environ.pop("GS_LINK_GBPS")
    prof_launches = {name: c.launches for name, c in LAUNCH_COUNTERS.items()}
    print(f"profiler path: P={prof['P']} entries={prof['entries']} capacity={prof['capacity']} "
          f"tiles={prof['tiles']} on {prof['device']}; launches {prof_launches}")
    bad = {k: v for k, v in prof["ms"].items() if not math.isfinite(v)}
    if bad:
        fail(f"profiler times not finite: {bad}")
    if prof_launches != {name: prof["calls"].get(name, 0) for name in LAUNCH_COUNTERS}:
        fail(f"profiler launches {prof_launches} differ from the calls it reports {prof['calls']}")
    sc = profile_stages.make_scene(prof["P"], W_MAIN, H_MAIN, (32, 16))
    with torch.no_grad():
        own_entries = int(preprocess(*sc.acts, 3, sc.cam, W_MAIN, H_MAIN, 32, 16).tiles_touched.sum())
    del sc
    if prof["entries"] != own_entries:
        fail(f"profiler entry count {prof['entries']} vs {own_entries} from this script's preprocess")
    print(f"  entry count {own_entries} recomputed here; {len(prof['ms'])} lines, all finite")
    comm = prof["comm"]
    if comm["step_ms"] is None or not all(r["efficiency"] is not None and 0 < r["efficiency"] < 1
                                          for r in comm["rows"]):
        fail(f"comm: no efficiency table ({comm['step_ms']})")
    print(f"  comm: link rate {comm['link_bytes_per_s'] / 1e9:g} GB/s per direction is NVLink 4's "
          f"published figure (a specification, not a measurement); step {comm['step_ms']:.4f} ms "
          f"from this run's train stage; {len(comm['rows'])} rows")

    # The three kernels of this path at its shapes: (16, K) and (K, 16), K the capacity.
    K = prof["capacity"]
    gen = torch.Generator(device=dev).manual_seed(31)
    xt = torch.randn((16, K), generator=gen, device=dev)
    xs = torch.randn((K, 16), generator=gen, device=dev)
    tp_ms = cuda_time_ms(lambda: relayout_to_rows_cuda(xt), 50)
    tp_plain_ms = cuda_time_ms(lambda: relayout_to_rows_torch(xt), 50)
    tp_lib_ms = cuda_time_ms(lambda: xt.t().contiguous(), 50)
    tp_bound = bound_ms(2 * 64 * K, 0)  # 64 B read and 64 B written per column
    cr_ms = cuda_time_ms(lambda: consume_rows_cuda(xs), 50)
    cr_plain_ms = cuda_time_ms(lambda: consume_rows_torch(xs), 50)
    ct_ms = cuda_time_ms(lambda: consume_t_cuda(xs), 50)
    ct_plain_ms = cuda_time_ms(lambda: consume_t_torch(xs), 50)
    sum_lib_ms = cuda_time_ms(lambda: xs.sum(0), 50)
    sum_bound = bound_ms(64 * K + 64, 16 * K)  # the table read once, 16 sums written; one add per element
    print(f"  relayout_to_rows (16, {K}) {tp_ms:.4f} ms, plain {tp_plain_ms:.4f} ms, "
          f"x.t().contiguous() {tp_lib_ms:.4f} ms; {tp_bound[2]}")
    ct_occ = consume_t_occupancy(16, dev.index)
    print(f"  consume_rows ({K}, 16) {cr_ms:.4f} ms, plain {cr_plain_ms:.4f} ms; consume_t {ct_ms:.4f} ms, "
          f"plain {ct_plain_ms:.4f} ms; x.sum(0) {sum_lib_ms:.4f} ms; {sum_bound[2]}")
    print(f"  consume_t first pass at R=16: {ct_occ['registers']} registers per thread, "
          f"{ct_occ['threads']} threads per block, {ct_occ['blocks_per_sm']} resident blocks per SM")
    phase_done("6 profiler path")

    # ---- 7. result ----------------------------------------------------
    def entry(name, source, replaces, by_path, ms, plain, bound, library):
        return {"name": name, "route": "cuda", "source": f"gaussian_splatting_torch/csrc/{source}.cu",
                "replaces": replaces, "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": library}

    def by_path(name):  # each path's own count, read after its own reset
        if name in train_launches:
            return {"train": train_launches[name], "trainer": trainer_launches[name],
                    "cli_train": cli_train_launches[name], "cli_render": cli_render_launches[name],
                    "cli_blender": blender_launches[name], "user_train": user_train_launches[name],
                    "user_render": user_render_launches[name], "forms_train": forms_train_launches[name],
                    "dds_train": dds_train_launches[name], "avif_train": avif_train_launches[name],
                    "avif_filters_train": avif_filters_train_launches[name],
                    "avif_screen_train": avif_screen_train_launches[name],
                    "avif_grain_train": avif_grain_train_launches[name],
                    "jpeg_arith_train": jpeg_arith_train_launches[name],
                    "rare_forms_train": rare_forms_train_launches[name],
                    "pil_rest_train": pil_rest_train_launches[name],
                    "avif_grid_train": avif_grid_train_launches[name],
                    "avif_hbd_train": avif_hbd_train_launches[name],
                    **{path: counts[name] for path, counts in sharded_launches.items()},
                    "bench": bench_launches[name]}
        return {"profiler": prof_launches[name]}

    print(json.dumps({"kernels": [
        entry("composite_fwd", "composite_fwd", "gaussian_splatting_tpu/ops/composite_pallas.py:376",
              by_path("composite_fwd"), fwd_ms, fwd_plain_ms, fwd_bound, None),  # _fwd_kernel
        entry("composite_bwd", "composite_bwd", "gaussian_splatting_tpu/ops/composite_pallas.py:427",
              by_path("composite_bwd"), bwd_ms, bwd_plain_ms, bwd_bound, None),  # _bwd_kernel
        # _to_rows_kernel's one call site: the routing sums
        entry("route_grads", "route_grads", "gaussian_splatting_tpu/ops/relayout.py:50",
              by_path("route_grads"), route_ms, route_plain_ms, route_bound, index_add_ms),
        # tkern, and the function of _to_rows_kernel (gaussian_splatting_tpu/ops/relayout.py:50)
        entry("relayout_to_rows", "relayout", "tools/profile_stages.py:231",
              by_path("relayout_to_rows"), tp_ms, tp_plain_ms, tp_bound, tp_lib_ms),
        entry("consume_rows", "consume", "tools/profile_stages.py:427",  # _sum_rows_kernel
              by_path("consume_rows"), cr_ms, cr_plain_ms, sum_bound, sum_lib_ms),
        entry("consume_t", "consume", "tools/profile_stages.py:451",  # _sum_t_kernel
              by_path("consume_t"), ct_ms, ct_plain_ms, sum_bound, sum_lib_ms),
    ]}))
    phase_done("7 result")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
