from repro_torch.serving.engine import PortfolioServer, ServedModel, SimulatedJudge  # noqa: F401
from repro_torch.serving.gateway import MicroBatcher, RouterGateway  # noqa: F401
from repro_torch.serving.telemetry import Telemetry  # noqa: F401
