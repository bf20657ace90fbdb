"""Node-side control of the port's engine.

  autotune.py     KernelConfig (kernel routing), the startup tuner
                  resolve(), the persisted kernel profile and the prewarm
                  marker
  cryptoplane.py  SlotCoalescer (one plane flush per window of concurrent
                  verify/recombine submissions), FlushStats,
                  PlaneConfigError, kernel_inventory()
"""
