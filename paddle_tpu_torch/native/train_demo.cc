// Train-from-C++ demo: a non-Python entry point for the framework — the
// port's copy of paddle_tpu/native/train_demo.cc.
//
// The analog of the reference's C++ train demo
// (reference: paddle/fluid/train/demo/demo_trainer.cc — build the
// programs, run the startup program once, then iterate the main program
// from C++ without the python CLI).  The compute engine here is PyTorch
// with the port's CUDA kernels, hosted by libpython, so the deployment
// shape is: embed the interpreter via the CPython C API (no pybind),
// drive the same Program/Executor API a python entry would, and surface
// losses to the C++ side through the C API.
//
// Build + run (the build bakes in the Python that built it, so the
// embedded interpreter finds that Python's packages, torch included,
// and the checkout's paddle_tpu_torch):
//   sh paddle_tpu_torch/native/build_demo.sh   # -> paddle_tpu_torch/_build/
//   ./paddle_tpu_torch/_build/train_demo [steps]
// It trains on CUDAPlace(0); PADDLE_DEMO_PLACE=cpu runs it on the CPU.
// Prints "step K loss=..." lines and exits 0 on a decreasing loss.

#include <Python.h>

#include <cstdio>
#include <cstdlib>
#include <string>

#ifndef DEMO_PYTHON
#error "build with -DDEMO_PYTHON=<python executable> (build_demo.sh)"
#endif
#ifndef DEMO_REPO_ROOT
#error "build with -DDEMO_REPO_ROOT=<checkout> (build_demo.sh)"
#endif

namespace {

const char* kDriver = R"PY(
import os
import numpy as np
import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers

def build():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data('x', shape=[16, 13], append_batch_size=False)
        y = layers.data('y', shape=[16, 1], append_batch_size=False)
        pred = layers.fc(x, size=1)
        loss = layers.reduce_mean(layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    place = (fluid.CPUPlace() if os.environ.get('PADDLE_DEMO_PLACE') == 'cpu'
             else fluid.CUDAPlace(0))
    exe = fluid.Executor(place)
    exe.run(startup)
    return exe, main, loss

_exe, _main, _loss = build()
_rng = np.random.RandomState(0)
_w = _rng.rand(13, 1).astype('float32')

def train_step():
    xv = _rng.rand(16, 13).astype('float32')
    yv = xv @ _w
    (lv,) = _exe.run(_main, feed={'x': xv, 'y': yv},
                     fetch_list=[_loss])
    return float(np.asarray(lv).reshape(()))
)PY";

double call_train_step(PyObject* globals) {
  PyObject* result =
      PyRun_String("train_step()", Py_eval_input, globals, globals);
  if (result == nullptr) {
    PyErr_Print();
    std::exit(2);
  }
  double loss = PyFloat_AsDouble(result);
  Py_DECREF(result);
  return loss;
}

}  // namespace

int main(int argc, char** argv) {
  int steps = argc > 1 ? std::atoi(argv[1]) : 20;

  // the interpreter of the Python that built the demo (a virtualenv's
  // site-packages resolve from its executable's pyvenv.cfg)
  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  PyStatus status =
      PyConfig_SetBytesString(&config, &config.program_name, DEMO_PYTHON);
  if (!PyStatus_Exception(status)) status = Py_InitializeFromConfig(&config);
  PyConfig_Clear(&config);
  if (PyStatus_Exception(status)) {
    std::fprintf(stderr, "cannot start Python: %s\n",
                 status.err_msg ? status.err_msg : "?");
    return 2;
  }
  PyObject* main_module = PyImport_AddModule("__main__");  // borrowed
  PyObject* globals = PyModule_GetDict(main_module);       // borrowed

  // the checkout on sys.path so `import paddle_tpu_torch` resolves
  std::string path_setup =
      std::string("import sys\nsys.path.insert(0, r'''") + DEMO_REPO_ROOT +
      "''')\n";
  PyRun_SimpleString(path_setup.c_str());

  if (PyRun_String(kDriver, Py_file_input, globals, globals) == nullptr) {
    PyErr_Print();
    Py_Finalize();
    return 2;
  }

  double first_loss = 0.0, last_loss = 0.0;
  for (int i = 0; i < steps; ++i) {
    last_loss = call_train_step(globals);
    if (i == 0) first_loss = last_loss;
    std::printf("step %d loss=%.6f\n", i, last_loss);
  }
  Py_Finalize();

  if (!(last_loss < first_loss)) {
    std::fprintf(stderr, "loss did not decrease: %f -> %f\n", first_loss,
                 last_loss);
    return 1;
  }
  std::printf("train_demo ok: loss %.6f -> %.6f\n", first_loss, last_loss);
  return 0;
}
