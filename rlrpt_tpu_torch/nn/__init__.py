from rlrpt_tpu_torch.nn.dq_network import DQNetwork  # noqa: F401
from rlrpt_tpu_torch.nn.encoding import relative_vertex_encoding  # noqa: F401
