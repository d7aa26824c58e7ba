from repro_torch.design_models.base import DesignModel  # noqa: F401
from repro_torch.design_models.im2col import Im2colModel  # noqa: F401
from repro_torch.design_models.dnnweaver import DnnWeaverModel  # noqa: F401
from repro_torch.design_models.tpu_mesh import TpuMeshModel  # noqa: F401
