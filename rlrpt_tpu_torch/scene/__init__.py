from rlrpt_tpu_torch.scene.scene import Scene, build_scene  # noqa: F401
from rlrpt_tpu_torch.scene.cornell import cornell_box  # noqa: F401
from rlrpt_tpu_torch.scene import presets as presets  # noqa: F401
