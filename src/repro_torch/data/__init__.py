from repro_torch.data.synthetic import make_request_stream  # noqa: F401
