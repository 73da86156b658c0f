from repro_torch.runtime.serve_loop import (Request, ServeLoopConfig,
                                            run_serving)
from repro_torch.runtime.train_loop import (StragglerAbort, TrainLoopConfig,
                                            make_train_step, run_training)
