from lilac_tpu_torch.formats.sparse import SegBucketELL  # noqa: F401
from lilac_tpu_torch.formats import convert  # noqa: F401
