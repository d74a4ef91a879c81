from zonos_tpu_torch.serving.server import main

main()
