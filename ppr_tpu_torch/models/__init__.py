from .config import AlgoConf, AlgoType  # noqa: F401
from .fora import ForaTopk, ForaWholeGraph  # noqa: F401
from .monte_carlo import MonteCarlo  # noqa: F401
from .power_method import PowerMethod  # noqa: F401
