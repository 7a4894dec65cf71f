"""Deep-Q (neural network guided) path tracing, the counterpart of
``rlrpt_tpu/deep/``."""

from rlrpt_tpu_torch.deep.neural_q import (NeuralQState, init_neural_q,
                                           render_frame_neural_q)  # noqa: F401
from rlrpt_tpu_torch.deep.pretrained import render_frame_pretrained  # noqa: F401
