from repro_torch.train.loop import (InjectedFailure, TrainLoop,
                                    TrainLoopConfig)
