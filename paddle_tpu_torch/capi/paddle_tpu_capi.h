/* C inference ABI for paddle_tpu_torch.
 *
 * The declarations, enum values and the PD_Tensor layout are those of
 * paddle_tpu/capi/paddle_tpu_capi.h, unchanged: a C client written
 * against either header compiles and links against either package's
 * libpaddle_tpu_capi.so.
 *
 * Capability parity with the reference's C inference surfaces:
 *   - paddle/legacy/capi (gradient_machine C API for embedding inference)
 *   - paddle/fluid/inference/api/paddle_inference_api.h:66-150
 *     (PaddleTensor / PaddlePredictor / CreatePaddlePredictor)
 *
 * The shim embeds CPython and drives the SAME predictor the Python side
 * uses (paddle_tpu_torch.capi_runtime: load_inference_model and a
 * prepared Executor run, on CUDAPlace(0) unless
 * PADDLE_TPU_TORCH_CAPI_PLACE=cpu). The ABI is pure C so any language
 * with an FFI can load libpaddle_tpu_capi.so against a model directory
 * written by fluid.io.save_inference_model.
 *
 * Thread-model: calls are serialized on the embedded interpreter's GIL.
 */
#ifndef PADDLE_TPU_CAPI_H_
#define PADDLE_TPU_CAPI_H_

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef enum {
  PD_FLOAT32 = 0,
  PD_INT32 = 1,
  PD_INT64 = 2,
} PD_DType;

typedef struct {
  const char* name;      /* feed target name (NULL = positional) */
  PD_DType dtype;
  const int64_t* shape;  /* dims, length `rank` */
  int rank;
  const void* data;      /* caller-owned contiguous buffer */
} PD_Tensor;

typedef void* PD_Predictor;
typedef void* PD_Results;

/* Load a model saved by fluid.io.save_inference_model. Returns NULL on
 * failure; PD_LastError() describes why. */
PD_Predictor PD_CreatePredictor(const char* model_dir);

/* Run inference. Returns a results handle (NULL on failure). */
PD_Results PD_PredictorRun(PD_Predictor pred, const PD_Tensor* inputs,
                           int num_inputs);

int PD_ResultsNum(PD_Results res);
const char* PD_ResultsName(PD_Results res, int i);
PD_DType PD_ResultsDType(PD_Results res, int i);
int PD_ResultsRank(PD_Results res, int i);
const int64_t* PD_ResultsShape(PD_Results res, int i);
const void* PD_ResultsData(PD_Results res, int i);   /* valid until destroy */
size_t PD_ResultsByteSize(PD_Results res, int i);

void PD_DestroyResults(PD_Results res);
void PD_DestroyPredictor(PD_Predictor pred);

/* Last error message for the calling thread ("" when none). */
const char* PD_LastError(void);

#ifdef __cplusplus
}
#endif
#endif /* PADDLE_TPU_CAPI_H_ */
