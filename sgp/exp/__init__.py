from sgp.exp.common import (Experiment, get_dataset, get_splitter,
                            load_config)

__all__ = ["Experiment", "get_dataset", "get_splitter", "load_config"]
