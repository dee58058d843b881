from repro_torch.data.synthetic import make_request_stream  # noqa: F401
from repro_torch.data.synthetic import (  # noqa: F401
    diurnal_tenant_stream, flash_crowd_tenant_stream, tenant_mix_stream,
    tenant_stream_for_spec,
)
