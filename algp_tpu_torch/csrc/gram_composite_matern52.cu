// The composite Gram kernel's instances whose spatial kind is matern52
// (gram.cuh), in a source of their own so that nvcc builds the three
// spatial kinds in parallel; gram.cu's `algp_gram` dispatches here.

#include "gram.cuh"

ALGP_COMPOSITE_LAUNCH(algp_gram_composite_matern52) {
  return launch_composite_fk<kMatern52>(fk, x1, x2, inv, scale, out, n1, n2, ds, df, st);
}
