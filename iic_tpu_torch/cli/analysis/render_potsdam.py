"""Analysis: render predictions of a Potsdam run
(``iic_tpu/cli/analysis/render_potsdam.py``): ``render_general``'s
machinery, the dataset coming from the stored config."""

from iic_tpu_torch.cli.analysis.render_general import main

if __name__ == "__main__":
    main()
