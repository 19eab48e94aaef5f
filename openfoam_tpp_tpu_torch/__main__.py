from openfoam_tpp_tpu_torch.manager.cli import main

raise SystemExit(main())
