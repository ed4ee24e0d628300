// K9's logic: the sync slice loop's condition (mythril_tpu/laser/tpu/
// engine.py:1427 _run_impl cond: t < max_steps and any lane alive and
// RUNNING). The control word is ctl = [t, continue, any_running, unused];
// a kernel given it reads ctl[1] first and returns at once when it is 0.
// Once the loop has stopped it stays stopped, as a while_loop does.
#pragma once
#include "common.cuh"

MT_DEV int lane_running(const uint8_t* alive, const int32_t* status, int l) {
  return alive[l] && status[l] == RUNNING;
}

MT_DEV void slice_ctl_commit(int32_t* ctl, int any_running, int max_steps) {
  int t = ctl[0];
  int cont = (t == 0 || ctl[1]) && t < max_steps && any_running;
  ctl[2] = any_running;
  ctl[1] = cont;
  ctl[0] = t + cont;
}
