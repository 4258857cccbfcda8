"""Static HTML index of the training sample grids: the port's copy of
``munit_tpu/utils/html.py`` (write_html/write_one_row_html,
utils.py:817-834): newest first, one row per snapshot iteration."""

from __future__ import annotations

import os


def write_one_row_html(f, iterations: int, img_path: str, all_size: int,
                       base_dir: str = ""):
    # links relative to the html file, so the run directory can move
    rel = os.path.relpath(img_path, base_dir) if base_dir else img_path
    f.write(f"<h3>iteration [{iterations}] ({os.path.basename(img_path)})</h3>")
    f.write(f'<p><a href="{rel}"><img src="{rel}" '
            f'style="width:{all_size}px"></a><br></p>')


def write_html(filename: str, iterations: int, image_save_iterations: int,
               image_directory: str, all_size: int = 1536):
    base = os.path.dirname(os.path.abspath(filename))
    with open(filename, "w") as f:
        f.write("<html><head><title>munit_tpu samples</title></head><body>")
        p = os.path.join(image_directory, "gen_a2b_train_current.jpg")
        if os.path.exists(p):
            write_one_row_html(f, iterations, p, all_size, base)
            write_one_row_html(
                f, iterations,
                os.path.join(image_directory, "gen_b2a_train_current.jpg"),
                all_size, base)
        for it in range(iterations, -1, -image_save_iterations):
            for kind in ("test", "train"):
                p = os.path.join(image_directory,
                                 f"gen_a2b_{kind}_{it:08d}.jpg")
                if os.path.exists(p):
                    write_one_row_html(f, it, p, all_size, base)
                    write_one_row_html(
                        f, it,
                        os.path.join(image_directory,
                                     f"gen_b2a_{kind}_{it:08d}.jpg"),
                        all_size, base)
        f.write("</body></html>")
