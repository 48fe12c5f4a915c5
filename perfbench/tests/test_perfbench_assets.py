"""The frozen generator writes the GLB that the port's generator writes,
byte for byte, so the stand-in scene is the one the port's records
measured."""
import os

from perfbench.assets import procedural


def test_frozen_glb_equals_the_ports(tmp_path):
    from rustray_tpu_torch.models.procedural import ensure_bench_assets
    ensure_bench_assets(str(tmp_path / "port"), grid=2)
    port = tmp_path / "port" / "sponza_class_g2_52x68.glb"
    ours = tmp_path / "ours.glb"
    procedural.write_sponza_glb(str(ours), grid=2)
    assert os.path.getsize(ours) > 100_000
    assert ours.read_bytes() == port.read_bytes()


def test_spheres_specs_equal_the_ports_demo_scene():
    from rustray_tpu_torch.models.procedural import demo_spheres_scene
    scene = demo_spheres_scene()
    spheres = [it for it in scene.items if it.basic.name.startswith("sphere")]
    assert len(spheres) == len(procedural.SPHERE_SPECS)
    for it, (pos, r, color, refl, alpha) in zip(spheres,
                                                 procedural.SPHERE_SPECS):
        assert it.radius == r
        assert tuple(it.basic.trans[:3, 3]) == pos
        mat = it.get_material()
        assert tuple(mat.base_color) == tuple(
            float(x) for x in __import__("numpy").float32(color))
        assert (mat.reflectivity, mat.alpha) == (refl, alpha)
