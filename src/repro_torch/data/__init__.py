from repro_torch.data.synthetic import (  # noqa: F401
    SyntheticLMDataset, make_request_stream,
)
from repro_torch.data.synthetic import (  # noqa: F401
    diurnal_tenant_stream, flash_crowd_tenant_stream, tenant_mix_stream,
    tenant_stream_for_spec,
)
