% ConexTpuProgram — MATLAB/Octave handle over libconex_tpu.so.
%
% Drop-in counterpart of the reference's util/ConexProgram.m
% (/root/reference/interfaces/matlab/util/ConexProgram.m:28-38): the same
% loadlibrary/calllib pattern against the same CONEX_* ABI, pointed at
% libconex_tpu.so so the solves run through the JAX solver.
%
% Every method maps to one extern-C symbol of interfaces/conex_tpu.h;
% tests/test_matlab_twin.py drives the identical call sequence through
% ctypes so the shim's data layout is validated without a MATLAB runtime.
classdef ConexTpuProgram < handle
  properties(Access=private)
    p
    constraints
  end

  properties(Access=public)
    options
  end

  methods(Static)
    function [m, n] = VerifyLMIData(A, c)
      % A: n x (n*m) horizontal stack of the m operator matrices; c: n x n.
      if size(c, 2) ~= size(c, 1)
        error('Affine term c must be a square matrix.')
      end
      n = size(c, 1);
      if n == 0 || mod(size(A, 2), n) ~= 0 || size(A, 1) ~= n
        error('LMI matrices have incompatible dimensions.')
      end
      m = size(A, 2) / n;
    end
  end

  methods
    function self = ConexTpuProgram(num_vars)
      if ~libisloaded('libconex_tpu')
        loadlibrary libconex_tpu.so conex_tpu.h
      end
      self.p = calllib('libconex_tpu', 'CONEX_CreateConeProgram');
      calllib('libconex_tpu', 'CONEX_SetNumberOfVariables', self.p, num_vars);
      self.options = libstruct('CONEX_SolverConfiguration');
      % Touch a field so MATLAB allocates the struct before the C write.
      self.options.divergence_upper_bound = 1;
      calllib('libconex_tpu', 'CONEX_SetDefaultOptions', self.options);
      self.options.prepare_dual_variables = 1;
      self.constraints = [];
    end

    function delete(self)
      calllib('libconex_tpu', 'CONEX_DeleteConeProgram', self.p);
    end

    function AddLinearInequality(self, A, c)
      % c - A y >= 0 elementwise.
      num_var = size(A, 2);
      rows = size(A, 1);
      Aptr = libpointer('doublePtr', full(A(:)));
      cptr = libpointer('doublePtr', full(c));
      self.constraints(end + 1) = calllib('libconex_tpu', ...
        'CONEX_AddDenseLinearConstraint', self.p, Aptr, rows, num_var, ...
        cptr, rows);
    end

    function AddLinearInequalities(self, A, lb, ub)
      % Box constraints lb <= A y <= ub (split + normalized in the solver).
      rows = size(A, 1);
      cols = size(A, 2);
      Aptr = libpointer('doublePtr', full(A(:)));
      lptr = libpointer('doublePtr', full(lb));
      uptr = libpointer('doublePtr', full(ub));
      calllib('libconex_tpu', 'CONEX_AddLinearInequalities', self.p, ...
        Aptr, rows, cols, lptr, rows, uptr, rows);
    end

    function AddQuadraticCost(self, Q)
      n = size(Q, 1);
      Qptr = libpointer('doublePtr', full(Q(:)));
      calllib('libconex_tpu', 'CONEX_AddQuadraticCost', self.p, Qptr, n, n);
    end

    function AddLinearMatrixInequality(self, A, c, variables)
      if nargin < 4
        self.AddDenseLinearMatrixInequality(A, c)
      else
        self.AddSparseLinearMatrixInequality(A, c, variables)
      end
    end

    function AddDenseLinearMatrixInequality(self, A, c)
      [m, n] = ConexTpuProgram.VerifyLMIData(A, c);
      Aptr = libpointer('doublePtr', full(A(:)));
      cptr = libpointer('doublePtr', full(c));
      self.constraints(end + 1) = calllib('libconex_tpu', ...
        'CONEX_AddDenseLMIConstraint', self.p, Aptr, n, n, m, cptr, n, n);
    end

    function AddSparseLinearMatrixInequality(self, A, c, vars)
      % vars: zero-based variable indices, one per operator matrix.
      [m, n] = ConexTpuProgram.VerifyLMIData(A, c);
      Aptr = libpointer('doublePtr', full(A(:)));
      cptr = libpointer('doublePtr', full(c));
      vptr = libpointer('longPtr', int64(full(vars(:))));
      self.constraints(end + 1) = calllib('libconex_tpu', ...
        'CONEX_AddSparseLMIConstraint', self.p, Aptr, n, n, m, cptr, n, n, ...
        vptr, m);
    end

    function x = GetDualVariable(self, i)
      sz = calllib('libconex_tpu', 'CONEX_GetDualVariableSize', self.p, i);
      xptr = libpointer('doublePtr', zeros(sz, 1));
      calllib('libconex_tpu', 'CONEX_GetDualVariable', self.p, i, xptr, sz, 1);
      x = xptr.Value;
    end

    function [y, x, status] = Maximize(self, b)
      if size(b, 2) > 1 && size(b, 1) > 1
        error('Cost must be a vector.')
      end
      num_var = length(b);
      bptr = libpointer('doublePtr', full(b));
      yptr = libpointer('doublePtr', zeros(num_var, 1));
      status = calllib('libconex_tpu', 'CONEX_Maximize', self.p, bptr, ...
        num_var, self.options, yptr, num_var);
      x = {};
      for i = 1:length(self.constraints)
        x{i} = self.GetDualVariable(self.constraints(i));
      end
      y = yptr.Value;
    end

    function [y, status] = Solve(self, num_var)
      % Solve with the accumulated cost terms (QP path; CONEX_Solve).
      yptr = libpointer('doublePtr', zeros(num_var, 1));
      status = calllib('libconex_tpu', 'CONEX_Solve', self.p, ...
        self.options, yptr, num_var);
      y = yptr.Value;
    end

    function stats = GetIterationStats(self, iter_num)
      s = libstruct('CONEX_IterationStats');
      s.mu = 0;
      calllib('libconex_tpu', 'CONEX_GetIterationStats', self.p, s, iter_num);
      stats.mu = s.mu;
      stats.iteration_number = s.iteration_number;
    end
  end
end
