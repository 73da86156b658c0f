from repro_torch.runtime.serve_loop import (Request, ServeLoopConfig,
                                            run_serving)
