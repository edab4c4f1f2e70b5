/* Writes the JPEG forms PIL's writer does not: arithmetic-coded (SOF9,
 * SOF10, with DAC) and lossless (SOF3) files, through libjpeg-turbo 3's own
 * encoder (the library PIL bundles), as jpegtran -arithmetic and
 * cjpeg -lossless write them.
 *
 * Built against any libjpeg-turbo jpeglib.h (the 2.1 header lacks
 * jpeg_enable_lossless, declared here) and linked to a libjpeg-turbo 3
 * library, which has the arithmetic and lossless codecs:
 *
 *   cc -O2 -o jpeg_writer jpeg_writer.c -L<dir> -l:<libjpeg.so> -Wl,-rpath,<dir>
 *
 * Usage (options are key=value):
 *
 *   jpeg_writer arith IN.jpg OUT.jpg [rows=N] [mcus=N] [L=l] [U=u] [K=k]
 *       IN's coefficients, losslessly, arithmetic-coded: progressive where IN
 *       is (jpeg_simple_progression's script), a restart marker every N MCU
 *       rows or every N MCUs, the DC conditioning L and U and the AC
 *       conditioning K of every table (defaults 0, 1, 5).
 *
 *   jpeg_writer lossless IN.raw OUT.jpg W H C psv=P pt=T [colour=grey|rgb|ycc|rgb2ycc]
 *               [sampling=HxV] [rows=N] [mcus=N] [scans=one] [psvs=P,P,P]
 *       IN holds H x W x C bytes. colour: grey (C 1), rgb (stored as RGB,
 *       with an Adobe marker), ycc (the bytes are already Y, Cb, Cr; a JFIF
 *       marker), rgb2ycc (converted by the library). sampling: the first
 *       component's factors (the others 1x1). scans=one: one scan per
 *       component, psvs giving each scan's predictor.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

void jpeg_enable_lossless(j_compress_ptr cinfo, int predictor_selection_value, int point_transform);

static const char *opt(int argc, char **argv, const char *key, const char *dflt) {
  size_t n = strlen(key);
  for (int i = 1; i < argc; ++i)
    if (strncmp(argv[i], key, n) == 0 && argv[i][n] == '=') return argv[i] + n + 1;
  return dflt;
}

static int iopt(int argc, char **argv, const char *key, int dflt) {
  const char *v = opt(argc, argv, key, NULL);
  return v ? atoi(v) : dflt;
}

static void restarts(j_compress_ptr c, int argc, char **argv) {
  c->restart_in_rows = iopt(argc, argv, "rows", 0);
  c->restart_interval = (unsigned int)iopt(argc, argv, "mcus", 0);
}

static int arith(int argc, char **argv) {
  struct jpeg_decompress_struct src;
  struct jpeg_compress_struct dst;
  struct jpeg_error_mgr e1, e2;
  FILE *in = fopen(argv[2], "rb"), *out = fopen(argv[3], "wb");
  if (!in || !out) return 1;
  src.err = jpeg_std_error(&e1);
  jpeg_create_decompress(&src);
  jpeg_stdio_src(&src, in);
  jpeg_read_header(&src, TRUE);
  jvirt_barray_ptr *coefs = jpeg_read_coefficients(&src);
  dst.err = jpeg_std_error(&e2);
  jpeg_create_compress(&dst);
  jpeg_stdio_dest(&dst, out);
  jpeg_copy_critical_parameters(&src, &dst);
  dst.arith_code = TRUE;
  dst.optimize_coding = FALSE;
  for (int i = 0; i < NUM_ARITH_TBLS; ++i) {
    dst.arith_dc_L[i] = (UINT8)iopt(argc, argv, "L", 0);
    dst.arith_dc_U[i] = (UINT8)iopt(argc, argv, "U", 1);
    dst.arith_ac_K[i] = (UINT8)iopt(argc, argv, "K", 5);
  }
  if (src.progressive_mode) jpeg_simple_progression(&dst);
  restarts(&dst, argc, argv);
  jpeg_write_coefficients(&dst, coefs);
  jpeg_finish_compress(&dst);
  jpeg_destroy_compress(&dst);
  jpeg_finish_decompress(&src);
  jpeg_destroy_decompress(&src);
  fclose(in);
  fclose(out);
  return 0;
}

static int lossless(int argc, char **argv) {
  int w = atoi(argv[4]), h = atoi(argv[5]), nc = atoi(argv[6]);
  size_t n = (size_t)w * h * nc;
  unsigned char *pixels = malloc(n);
  FILE *in = fopen(argv[2], "rb"), *out = fopen(argv[3], "wb");
  if (!pixels || !in || !out || fread(pixels, 1, n, in) != n) return 1;
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr err;
  c.err = jpeg_std_error(&err);
  jpeg_create_compress(&c);
  jpeg_stdio_dest(&c, out);
  c.image_width = (JDIMENSION)w;
  c.image_height = (JDIMENSION)h;
  c.input_components = nc;
  const char *colour = opt(argc, argv, "colour", nc == 1 ? "grey" : "rgb");
  c.in_color_space = nc == 1   ? JCS_GRAYSCALE
                     : nc == 4 ? JCS_CMYK
                     : strcmp(colour, "ycc") == 0 ? JCS_YCbCr : JCS_RGB;
  jpeg_set_defaults(&c);
  /* jpeg_enable_lossless sets the colour space to the input's; what is
     asked for comes after it */
  jpeg_enable_lossless(&c, iopt(argc, argv, "psv", 1), iopt(argc, argv, "pt", 0));
  if (nc == 1)
    jpeg_set_colorspace(&c, JCS_GRAYSCALE);
  else if (nc == 3)
    jpeg_set_colorspace(&c, strcmp(colour, "rgb") == 0 ? JCS_RGB : JCS_YCbCr);
  const char *sampling = opt(argc, argv, "sampling", "1x1");
  c.comp_info[0].h_samp_factor = sampling[0] - '0';
  c.comp_info[0].v_samp_factor = sampling[2] - '0';
  for (int i = 1; i < nc; ++i) c.comp_info[i].h_samp_factor = c.comp_info[i].v_samp_factor = 1;
  jpeg_scan_info scans[4];
  if (strcmp(opt(argc, argv, "scans", "all"), "one") == 0) {
    const char *p = opt(argc, argv, "psvs", NULL);
    for (int i = 0; i < nc; ++i) {
      scans[i].comps_in_scan = 1;
      scans[i].component_index[0] = i;
      scans[i].Ss = p ? p[2 * i] - '0' : iopt(argc, argv, "psv", 1);
      scans[i].Se = 0;
      scans[i].Ah = 0;
      scans[i].Al = iopt(argc, argv, "pt", 0);
    }
    c.scan_info = scans;
    c.num_scans = nc;
  }
  restarts(&c, argc, argv);
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = pixels + (size_t)c.next_scanline * w * nc;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  fclose(in);
  fclose(out);
  free(pixels);
  return 0;
}

int main(int argc, char **argv) {
  if (argc >= 4 && strcmp(argv[1], "arith") == 0) return arith(argc, argv);
  if (argc >= 7 && strcmp(argv[1], "lossless") == 0) return lossless(argc, argv);
  fprintf(stderr, "usage: jpeg_writer arith IN OUT [...] | lossless IN OUT W H C [...]\n");
  return 2;
}
